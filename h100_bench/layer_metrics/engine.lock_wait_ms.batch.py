"""`engine/engine.py` `Engine.search`: the mean `engine.lock` span a
search, the time spent acquiring the `RWLock`'s exclusive side (to
settle) and then its shared side, summed over retries."""

from harness.program_spans import per_search_ms


def read(ctx):
    return per_search_ms(ctx, "engine.lock")

"""`engine/engine.py` `Engine.search`: the mean `engine.scan` span a
search, the index's `search` (the kernels' host issue, the wait for the
card and the copy back)."""

from harness.program_spans import per_search_ms


def read(ctx):
    return per_search_ms(ctx, "engine.scan")

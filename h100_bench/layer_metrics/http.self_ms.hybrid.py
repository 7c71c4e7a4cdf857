"""`server/http.py` + `server/batcher.py`: the mean `http.request` span
less what its child spans and its batch's `Engine.search` cover (the
hand-offs to and from the worker thread, the event loop's delays)."""

from harness.program_spans import note_decomposition, self_ms


def read(ctx):
    note_decomposition(ctx)
    return self_ms(ctx)

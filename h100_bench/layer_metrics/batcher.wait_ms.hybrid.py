"""`server/batcher.py`: the mean `batcher.wait` span of a request, from
its enqueue until its batch's `Engine.search` starts (the batcher's
window, the hand-off to a worker thread)."""

from harness.program_spans import WAIT, per_request_ms


def read(ctx):
    return per_request_ms(ctx, (WAIT,))

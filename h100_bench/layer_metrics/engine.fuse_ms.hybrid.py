"""`engine/engine.py` and `ops/fuse.py`: the mean `engine.fuse` span a
search, `fused_topk` (the text candidates' upload, the fused epilogue's
kernels, the wait for the card and the one copy back)."""

from harness.program_spans import per_search_ms


def read(ctx):
    return per_search_ms(ctx, "engine.fuse")

"""`engine/engine.py` `Engine.search`: the mean `engine.assemble` span a
search (`_assemble_fast`: scores, the ids, the columnar arrays)."""

from harness.program_spans import per_search_ms


def read(ctx):
    return per_search_ms(ctx, "engine.assemble")

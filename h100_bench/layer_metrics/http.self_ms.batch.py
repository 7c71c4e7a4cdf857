"""`server/http.py`: the mean `http.request` span less what its child
spans cover (the thread hand-offs and the event loop's delays); also
notes the request's whole decomposition."""

from harness.program_spans import note_decomposition, self_ms


def read(ctx):
    note_decomposition(ctx)
    return self_ms(ctx)

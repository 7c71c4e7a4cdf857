"""`server/http.py`: the mean of the `http.body` (the body's read and
JSON parse) and `http.decode` (base64 and `np.frombuffer` of the
queries) spans of a request."""

from harness.program_spans import BODY, DECODE, per_request_ms


def read(ctx):
    return per_request_ms(ctx, (BODY, DECODE))

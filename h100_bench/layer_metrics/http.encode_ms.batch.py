"""`server/http.py`: the mean `http.encode` span of a request, what the
batched search does after `Engine.search` returns (base64 of the scores
and distances, the ids joined, `json.dumps`)."""

from harness.program_spans import ENCODE, per_request_ms


def read(ctx):
    return per_request_ms(ctx, (ENCODE,))

"""`server/http.py` + `server/batcher.py`: mean client latency less the
mean `Engine.search` span (request parsing, the batcher's window, the
answer's encoding, the wire)."""

from harness.layers import server_self_ms as read  # noqa: F401

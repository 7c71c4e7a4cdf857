"""aiohttp and the wire: the mean client latency (send to answer) less
the mean `http.request` span (the header read and the response write
outside the middleware, the bytes on the loopback)."""

from harness.program_spans import outside_ms as read  # noqa: F401

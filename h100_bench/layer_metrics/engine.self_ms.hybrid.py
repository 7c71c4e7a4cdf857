"""`engine/engine.py` `Engine.search`: its span less the BM25 span inside
it (locks, settle, the scan's host side, fusion, the hit assembly)."""

from harness.layers import engine_self_ms as read  # noqa: F401

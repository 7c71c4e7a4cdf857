"""Arithmetic the per-layer readers share (layer_metrics/*.py)."""

import numpy as np


def mean_ms(spans) -> float | None:
    if not spans:
        return None
    return float(np.mean([e - s for s, e, *_ in spans])) * 1e3


def server_self_ms(ctx):
    """Mean client latency (send to answer) less the mean Engine.search
    span, outside the traced slice: one search a request."""
    client = ctx.client_spans()
    search = ctx.search_spans()
    if not client or not search:
        return None
    ctx.note(f"server self ms: {len(client)} requests, {len(search)} "
             f"searches")
    return mean_ms(client) - mean_ms(search)


def engine_self_ms(ctx):
    """Mean Engine.search span less the mean text span inside it, per
    search."""
    search = ctx.search_spans()
    if not search:
        return None
    text = ctx.text_spans()
    text_ms = sum(e - s for s, e in text) * 1e3 / len(search)
    return mean_ms(search) - text_ms


def device_idle(ctx):
    """1 - the union of device operations over the traced slice."""
    from harness.tracing import union_seconds
    events, window = ctx.device_events()
    if events is None:
        return None
    busy = union_seconds([(s, e) for _, s, e in events], *window)
    return 1.0 - busy / (window[1] - window[0])

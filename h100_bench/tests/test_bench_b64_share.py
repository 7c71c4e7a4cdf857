"""`http.b64_native_share.batch` reads the program's two counters of
batched-search bodies with `query_vectors_b64`, and nothing where the
program keeps neither or has no tracing module."""

import sys

import pytest

from harness import spec as speclib

NATIVE, FALLBACK = "http.queries_b64.native", "http.queries_b64.fallback"


@pytest.mark.parametrize("counts, share", [
    ({}, None),
    ({"engine.search_retries": 4}, None),
    ({NATIVE: 7}, 1.0),
    ({NATIVE: 3, FALLBACK: 1}, 0.75),
    ({FALLBACK: 2}, 0.0),
])
def test_share_of_the_counters(counts, share, monkeypatch):
    from kektordb_tpu_torch import tracing
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    reader = speclib.plugin("layer_metrics", "http.b64_native_share.batch")
    assert reader.read(None) == share


def test_none_without_the_tracing_module(monkeypatch):
    import kektordb_tpu_torch
    monkeypatch.setitem(sys.modules, "kektordb_tpu_torch.tracing", None)
    monkeypatch.delattr(kektordb_tpu_torch, "tracing", raising=False)
    reader = speclib.plugin("layer_metrics", "http.b64_native_share.batch")
    assert reader.read(None) is None

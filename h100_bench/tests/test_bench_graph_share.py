"""`beam.graph_share.beam1024` reads the program's two counters of the
beam's blocks, replayed and eager, and nothing where the program keeps
neither or has no tracing module."""

import sys

import pytest

from harness import spec as speclib

REPLAYS, EAGER = "beam.graph_replays", "beam.eager_blocks"


@pytest.mark.parametrize("counts, share", [
    ({}, None),
    ({"beam.graph_captures": 2, "beam.searches": 6}, None),
    ({REPLAYS: 90}, 1.0),
    ({REPLAYS: 90, EAGER: 10}, 0.9),
    ({EAGER: 15}, 0.0),
])
def test_share_of_the_counters(counts, share, monkeypatch):
    from kektordb_tpu_torch import tracing
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    reader = speclib.plugin("layer_metrics", "beam.graph_share.beam1024")
    assert reader.read(None) == share


def test_none_without_the_tracing_module(monkeypatch):
    import kektordb_tpu_torch
    monkeypatch.setitem(sys.modules, "kektordb_tpu_torch.tracing", None)
    monkeypatch.delattr(kektordb_tpu_torch, "tracing", raising=False)
    reader = speclib.plugin("layer_metrics", "beam.graph_share.beam1024")
    assert reader.read(None) is None

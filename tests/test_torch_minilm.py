"""The port's MiniLM encoder (kektordb_tpu_torch/services/minilm.py) held
to the JAX package's.

* One parameter dict (2 layers, width 64, 4 heads) and one ragged batch
  go through the reference's `_bert_forward` and the port's forward, mean
  and CLS pooling: the embeddings agree within 2e-6 absolute (float32 in
  both, the products summed in another order), and the full-width MiniLM
  shape (6 layers, 384, 12 heads) within 5e-6.
* The reference's own cases (tests/test_minilm.py, including the
  safetensors and tokenizers round trip, pooling detection and the
  embedder factory) and its seeded `transformers.BertModel` parity
  (tests/test_bert_torch_parity.py) run against the port: their source is
  read, every `kektordb_tpu` module becomes its `kektordb_tpu_torch` copy
  (test_torch_port_reference), and the encoder runs on DEVICE. So does
  tests/test_minilm_real.py's `test_download_wiring_probes_network` (the
  local model path, no network); its real-weights case needs the
  published checkpoint (NOT_TRANSPOSED).
* `MiniLMEmbedder` feeds an Engine on the CPU and a text search returns
  the document it was given.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_port_reference import DEVICE, reference_cases

from kektordb_tpu.services import minilm as jminilm
from kektordb_tpu_torch.services import minilm as tminilm

_HERE = Path(__file__).resolve().parent


class _DeviceEncoder(tminilm.MiniLMEncoder):
    """The port's encoder with DEVICE as its default device."""

    def __init__(self, *a, **kw):
        kw.setdefault("device", DEVICE)
        super().__init__(*a, **kw)

    @classmethod
    def from_params(cls, *a, **kw):
        kw.setdefault("device", DEVICE)
        return super().from_params(*a, **kw)


def _port_source(src: str) -> str:
    """`reference_cases` with the encoder made on DEVICE."""
    return re.sub(r"^(\s*)from kektordb_tpu_torch\.services\.minilm "
                  r"import MiniLMEncoder$",
                  r"\1MiniLMEncoder = _DeviceEncoder", src, flags=re.M)


exec(compile(_port_source(reference_cases("test_minilm.py")),
             str(_HERE / "test_minilm.py"), "exec"))
exec(compile(_port_source(reference_cases("test_bert_torch_parity.py")),
             str(_HERE / "test_bert_torch_parity.py"), "exec"))
exec(compile(reference_cases("test_minilm_real.py",
                             ["test_download_wiring_probes_network"]),
             str(_HERE / "test_minilm_real.py"), "exec"))


def test_reference_cases_were_ported():
    for ref in ("test_minilm.py", "test_bert_torch_parity.py"):
        src = _port_source(reference_cases(ref))
        assert "kektordb_tpu." not in src.replace("kektordb_tpu_torch.", "")
        assert "MiniLMEncoder = _DeviceEncoder" in src \
            or "from kektordb_tpu_torch.services.minilm" not in src


def _ragged(B, T, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    for b in range(1, B):
        mask[b, rng.integers(1, T):] = 0.0
    return ids, mask


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("shape,atol", [
    (dict(vocab_size=300, dim=64, n_layers=2, n_heads=4, intermediate=128,
          max_pos=64), 2e-6),
    (dict(vocab_size=1000, dim=384, n_layers=6, n_heads=12,
          intermediate=1536, max_pos=512), 5e-6),
], ids=["small", "minilm_l6"])
def test_forward_matches_reference(pooling, shape, atol):
    p = jminilm.MiniLMEncoder.random_params(seed=3, **shape)
    # non-trivial LayerNorm and bias terms, so no parameter is inert
    rng = np.random.default_rng(4)
    for k in p:
        if k.endswith(".bias") or "LayerNorm" in k:
            p[k] = p[k] + rng.normal(size=p[k].shape).astype(np.float32) * 0.1
    ids, mask = _ragged(5, 24, shape["vocab_size"], seed=5)
    want = np.asarray(jminilm._bert_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(ids),
        jnp.asarray(mask), n_layers=shape["n_layers"],
        n_heads=shape["n_heads"], pooling=pooling))
    enc = tminilm.MiniLMEncoder.from_params(
        p, lambda texts: (ids, mask), n_layers=shape["n_layers"],
        n_heads=shape["n_heads"], dim=shape["dim"], pooling=pooling,
        device="cpu")
    got = enc(ids, mask).numpy()
    assert got.shape == want.shape == (5, shape["dim"])
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # encode pads T to a power of two: the same rows
    np.testing.assert_allclose(enc.encode(["x"] * 5), want, rtol=0,
                               atol=atol)


def test_encode_pads_like_the_reference():
    """T = 5 pads to 8, T = 300 truncates to MAX_LEN = 256, in both."""
    p = jminilm.MiniLMEncoder.random_params(vocab_size=50, dim=32,
                                            n_layers=1, n_heads=4,
                                            intermediate=64, max_pos=512)
    for T in (5, 300):
        ids, mask = _ragged(3, T, 50, seed=T)
        tok = (lambda i, m: lambda texts: (i, m))(ids, mask)
        j = jminilm.MiniLMEncoder.from_params(p, tok, n_layers=1, n_heads=4,
                                              dim=32)
        t = tminilm.MiniLMEncoder.from_params(p, tok, n_layers=1, n_heads=4,
                                              dim=32, device="cpu")
        np.testing.assert_allclose(t.encode(["a"] * 3),
                                   j.encode(["a"] * 3), rtol=0, atol=2e-6)


def test_missing_loader_package_is_named(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="safetensors"):
        tminilm.MiniLMEncoder("custom", weights_dir="/nonexistent",
                              device="cpu")


def test_minilm_embedder_feeds_an_engine():
    from kektordb_tpu_torch.engine import Engine, EngineConfig
    from kektordb_tpu_torch.services.embeddings import MiniLMEmbedder

    p = tminilm.MiniLMEncoder.random_params(vocab_size=512, dim=64,
                                            n_layers=2, n_heads=4,
                                            intermediate=128)
    enc = tminilm.MiniLMEncoder.from_params(
        p, _stub_tokenizer(vocab=512, T=16), n_layers=2, n_heads=4, dim=64,
        device="cpu")
    emb = MiniLMEmbedder.from_encoder(enc)
    docs = [f"document {i} about topic {i % 7} and item {i * 13 % 101}"
            for i in range(200)]
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    e.create_index("docs", metric="cosine", m=8, ef_construction=32,
                   serve_mode="scan")
    e.add_batch("docs", [f"d{i}" for i in range(200)],
                emb.embed_batch(docs))
    for i in (0, 57, 199):
        assert e.search("docs", emb.embed(docs[i]), k=1)[0][0]["id"] \
            == f"d{i}"
    e.close()

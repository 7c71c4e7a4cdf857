"""BM25 and the journal's writers in the port (text/bm25.py,
persist/aof.py), the JAX package's tests/test_text_persist.py. Its
stemmer and RESP cases have their counterparts in test_torch_text.py and
test_torch_persist.py, and so do its lazy writer's shadow buffer and cap
flush; the rest is here.

* The reference's six `TestBM25` cases run against the port (its source
  read, every `kektordb_tpu` module made the port's), and ranking,
  remove, upsert and the delta fold run through both packages' BM25Index
  with the same scores and stats.
* `TestAOF`'s frame round trip and resync after corruption run through
  each package's synchronous `AOFWriter` (the port's lacked `write`), and
  each package's `replace_with` (the AOF rewrite's atomic swap; the
  port's writers lacked it) gives the same journal.
"""

import os

import pytest
from test_torch_native import private_reference_native
from test_torch_port_reference import reference_cases

from kektordb_tpu.persist import aof as jaof
from kektordb_tpu.text import bm25 as jbm25
from kektordb_tpu_torch.persist import aof as taof
from kektordb_tpu_torch.text import bm25 as tbm25

exec(compile(reference_cases("test_text_persist.py", ["TestBM25"]),
             "test_text_persist.py", "exec"))

PACKAGES = {"port": (taof, tbm25), "reference": (jaof, jbm25)}


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's replay scans on its C++ library, built for this
    module alone."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


def _ranking(bm25):
    idx = bm25.BM25Index()
    idx.add(1, "body", "vector database engine for vectors")
    idx.add(2, "body", "cats and dogs")
    idx.add(3, "body", "the vector is a mathematical object")
    idx.add(4, "title", "vector kernels")
    return [idx.search("vector database"), idx.search("kernels vector",
                                                      fields=["title"]),
            idx.stats()]


def _remove(bm25):
    idx = bm25.BM25Index()
    for r in range(6):
        idx.add(r, "body", f"alpha beta w{r}")
    idx.remove(2)
    idx.remove(4, "body")
    return [idx.search("alpha"), idx.search("w2"), idx.stats()]


def _upsert(bm25):
    idx = bm25.BM25Index()
    idx.add(1, "body", "alpha beta")
    idx.add(1, "body", "gamma")
    idx.add(2, "body", "gamma delta")
    out = [idx.search("alpha gamma"), idx.stats()]
    idx.add(2, "body", "the and of")          # stopwords only: row leaves
    return out + [idx.search("gamma delta"), idx.stats()]


def _delta_fold(bm25):
    idx = bm25.BM25Index()
    for r in range(8):
        idx.add(r, "body", f"alpha w{r}")
    out = [idx.search_arrays("alpha")]
    for r in range(8, 14):
        idx.add(r, "body", f"alpha alpha w{r}")
    idx.remove(3)
    out.append(idx._csr.get("body") is None)
    return out + [idx.search_arrays("alpha w9"), idx.stats()]


@pytest.mark.parametrize("case", [_ranking, _remove, _upsert, _delta_fold],
                         ids=lambda f: f.__name__.strip("_"))
def test_bm25_agrees_with_reference(case, monkeypatch):
    got = {}
    for name, (_, bm25) in PACKAGES.items():
        monkeypatch.setattr(bm25, "_FOLD_MIN", 4)   # the fold at 6 writes
        got[name] = case(bm25)

    def plain(x):
        if isinstance(x, tuple):
            return [a.tolist() for a in x]
        return x
    assert [plain(x) for x in got["port"]] == \
        [plain(x) for x in got["reference"]]


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_frame_roundtrip(package, tmp_path):
    aoflib = PACKAGES[package][0]
    p = str(tmp_path / "a.aof")
    w = aoflib.AOFWriter(p)
    w.write(b"one")
    w.write(b"two", opcode=7)
    w.close()
    frames = list(aoflib.read_frames(p))
    assert frames == [(aoflib.OP_COMMAND, b"one"), (7, b"two")]
    assert list(taof.read_frames(p)) == list(jaof.read_frames(p))


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_resync_after_corruption(package, tmp_path):
    aoflib = PACKAGES[package][0]
    p = str(tmp_path / "a.aof")
    w = aoflib.AOFWriter(p)
    for i in range(10):
        w.write(b"payload-%d" % i)
    w.close()
    size = os.path.getsize(p)
    with open(p, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\x00" * 4)
    hits = []
    got = [pl for _, pl in aoflib.read_frames(p, hits.append)]
    assert hits, "corruption must be reported"
    assert got[0] == b"payload-0"
    assert b"payload-9" in got  # frames after the corruption recovered
    assert got == [pl for _, pl in jaof.read_frames(p)]


def _rewritten(aoflib, tmp_path, lazy: bool) -> list[bytes]:
    """A journal with frames, then swapped for a rewritten one by
    replace_with, then written again: its payloads after close()."""
    p = str(tmp_path / "j.aof")
    w = (aoflib.LazyAOFWriter if lazy else aoflib.AOFWriter)(p)
    w.write(b"old-1")
    w.write(b"old-2")
    tmp = p + ".rewrite"
    with open(tmp, "wb") as f:
        f.write(aoflib.encode_frame(b"compacted"))
    w.replace_with(tmp)
    assert not os.path.exists(tmp)
    w.write(b"new", opcode=3)
    w.close()
    return list(aoflib.read_frames(p))


@pytest.mark.parametrize("lazy", [False, True], ids=["AOFWriter",
                                                     "LazyAOFWriter"])
def test_replace_with_agrees_with_reference(lazy, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    port = _rewritten(taof, tmp_path / "t", lazy)
    assert port == [(taof.OP_COMMAND, b"compacted"), (3, b"new")]
    assert port == _rewritten(jaof, tmp_path / "j", lazy)

"""The port's Engine under a real SIGKILL and under concurrent readers,
writers and its background thread, on the CPU: the guarantees the JAX
package's tests/test_crash_stress.py holds the reference to.

* test_sigkill_recovery (reference `:47`): a port process writing with
  fsync after each add is killed with SIGKILL; every acknowledged add
  comes back bit-equal, with the background thread off and on (then a
  snapshot and its journal truncation fall among the writes). The same
  killed data dir reopened by the JAX package gives the same ids and
  vectors.
* test_sigkill_mid_stage_backlog (`:209`): the killed writer's staged,
  unlinked adds replay, the scan finds them, the beam drains the backlog.
* test_storm (`:81` and `:141`): adders, a deleter, a metadata patcher
  and three readers at once, with the background thread off and on. The
  writers run a fixed count of operations (the reference's storm runs on
  a wall clock, so its work, its backlog and its time follow the host's
  speed). Every hit is a known id with a finite score, no hit is an id
  whose delete was acknowledged before the search began, every
  acknowledged add reads back bit-equal after the storm and after a
  reopen, and the `kektordb` logger records no ERROR.
* test_background_loop_survives_a_failed_tick: the logger check catches
  a failure injected into the background thread's run_maintenance, and
  the loop keeps running.
"""

import logging
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from test_torch_native import private_reference_native

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu_torch.engine import Engine, EngineConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
DIM = 8
BULK = 64           # rows of the writer's add_batch
MIN_ACKED = 80      # the last acknowledged id before the kill, at least


@pytest.fixture(scope="module", autouse=True)
def _reference_native(tmp_path_factory):
    """The reference's replay scans on its C++ library, built for this
    module alone."""
    with private_reference_native(tmp_path_factory.mktemp("ref_native")):
        yield


def vec(i: int, dim: int = DIM) -> np.ndarray:
    """The vector of id v{i}: a function of i alone, so the parent knows
    what every acknowledged add wrote."""
    return np.random.default_rng(i).normal(size=dim).astype(np.float32)


WRITER = """
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
from kektordb_tpu_torch.engine import Engine, EngineConfig

def vec(i):
    return np.random.default_rng(i).normal(size=%(dim)d).astype(np.float32)

e = Engine(EngineConfig(device="cpu", data_dir=%(data)r, %(cfg)s)).open()
e.create_index("crash", m=8, ef_construction=64)
e.add_batch("crash", [f"v{i}" for i in range(%(bulk)d)],
            np.stack([vec(i) for i in range(%(bulk)d)]))
e.kv_set("phase", b"bulk-done")
e._aof.flush(fsync=True)
print("READY", flush=True)
i = %(bulk)d
while True:          # every add journaled before RAM, then fsynced
    e.add("crash", f"v{i}", vec(i))
    e._aof.flush(fsync=True)
    print(f"W{i}", flush=True)
    i += 1
"""

# the writer's engine: the reference's (no background thread), and the
# server's deployment with a background thread that snapshots and links
WRITER_CONFIGS = {
    "no_background": "start_background=False",
    "background": "start_background=True, snapshot_interval=1.0, "
                  "snapshot_dirty_threshold=40, maintenance_interval=1.0",
}


class ErrorRecords(logging.Handler):
    """Collects the ERROR records of the `kektordb` logger (the background
    loop's `log.exception`) while a `with` block runs."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)

    def __enter__(self) -> "ErrorRecords":
        logging.getLogger("kektordb").addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        logging.getLogger("kektordb").removeHandler(self)

    def messages(self) -> list[str]:
        return [self.format(r) for r in self.records]


def kill_writer(data: str, cfg: str, min_acked: int = MIN_ACKED,
                min_seconds: float = 0.0) -> int:
    """Runs WRITER over `data`, SIGKILLs it once it acknowledged
    v{min_acked} and ran `min_seconds`, and returns the last acknowledged
    id's number."""
    proc = subprocess.Popen(
        [sys.executable, "-c", WRITER % {"repo": REPO, "data": data,
                                         "cfg": cfg, "dim": DIM,
                                         "bulk": BULK}],
        stdout=subprocess.PIPE, text=True)
    written = BULK - 1
    t_ready = None
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            line = proc.stdout.readline().strip()
            if not line:
                break
            if line == "READY":
                t_ready = time.time()
            elif line.startswith("W"):
                written = int(line[1:])
                if written >= min_acked \
                        and time.time() - t_ready >= min_seconds:
                    break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    assert written >= min_acked, "writer never got going"
    return written


@pytest.fixture(scope="module", params=sorted(WRITER_CONFIGS))
def killed(request, tmp_path_factory):
    """(writer config, data dir of a SIGKILLed writer, last acked id)."""
    data = str(tmp_path_factory.mktemp("killed") / "data")
    # with the background thread on, the writer runs long enough for its
    # 1 s tick to snapshot and truncate the journal among the writes
    secs = 2.5 if request.param == "background" else 0.0
    return request.param, data, kill_writer(
        data, WRITER_CONFIGS[request.param], min_seconds=secs)


def reopened(package, killed, tmp_path):
    """A copy of the killed data dir, opened by `package` ("port" or
    "reference") with no background thread."""
    data = str(tmp_path / "copy")
    shutil.copytree(killed[1], data)
    if package == "port":
        return Engine(EngineConfig(device="cpu", data_dir=data,
                                   start_background=False)).open()
    return JEngine(JEngineConfig(data_dir=data,
                                 start_background=False)).open()


def vectors_of(e, name: str, ids: list[str]) -> np.ndarray:
    idx = e.indexes[name].index
    return np.stack([np.asarray(idx.get_vector(x), np.float32) for x in ids])


def test_sigkill_recovery(killed, tmp_path):
    """Kill -9 a writing port process: the reopened port has every add the
    journal acknowledged, bit-equal (AOF-before-RAM across a hard crash)."""
    config, data, written = killed
    if config == "background":      # its thread checkpointed mid-writes
        assert os.listdir(os.path.join(data, "checkpoints"))
    e = reopened("port", killed, tmp_path)
    try:
        assert e.kv_get("phase") == b"bulk-done"
        idx = e.indexes["crash"].index
        assert len(idx) >= written + 1
        ids = [f"v{i}" for i in range(written + 1)]
        assert [e.get("crash", x)["id"] for x in ids] == ids
        np.testing.assert_array_equal(
            vectors_of(e, "crash", ids),
            np.stack([vec(i) for i in range(written + 1)]))
    finally:
        e.close()


def test_sigkill_data_dir_opens_alike_in_both_packages(killed, tmp_path):
    """The killed port writer's data dir, reopened by the port and by the
    JAX package: the same ids, the same vectors bit for bit."""
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    got = {}
    for package in ("port", "reference"):
        e = reopened(package, killed, tmp_path / package[0])
        try:
            idx = e.indexes["crash"].index
            ids = sorted(idx.ids.ext_to_row, key=lambda x: int(x[1:]))
            got[package] = (ids, vectors_of(e, "crash", ids),
                            e.kv_get("phase"))
        finally:
            e.close()
    (pi, pv, pk), (ri, rv, rk) = got["port"], got["reference"]
    assert pi == ri and pk == rk == b"bulk-done"
    assert len(pi) >= killed[2] + 1
    np.testing.assert_array_equal(pv, rv)


def test_sigkill_mid_stage_backlog(killed, tmp_path):
    """The writer's single adds were staged, not linked, when it died:
    replay restores them, the scan finds each one first, and the beam
    drains the link backlog."""
    _, _, written = killed
    e = reopened("port", killed, tmp_path)
    try:
        idx = e.indexes["crash"].index
        for i in (7, BULK, written):
            assert e.search("crash", vec(i), k=1)[0][0]["id"] == f"v{i}"
        d, rows = idx.search(vec(written)[None], 1, mode="beam")
        assert idx.ids.row_to_ext[int(rows[0, 0])] == f"v{written}"
        assert not idx._unlinked
    finally:
        e.close()


# -- the storm ---------------------------------------------------------------

STORM_SEEDS = 300       # rows before the storm: 0..199 deleted, 200.. patched
STORM_DIM = 16
ADDERS, ADDS = 2, 300   # per adder
DELETES = 200
PATCHES = 100
BG_CONFIG = dict(start_background=True, snapshot_interval=1.0,
                 snapshot_dirty_threshold=50, maintenance_interval=0.5)


class Storm:
    """Writers with fixed counts of operations and readers that run until
    the writers end, over one engine; each acknowledgement is recorded
    with its time.monotonic()."""

    def __init__(self, e: Engine, seeds: np.ndarray):
        self.e = e
        self.seeds = seeds
        self.errors: list[Exception] = []
        self.added: dict[str, np.ndarray] = {}
        self.deleted_at: dict[str, float] = {}
        self.known = {f"seed{i}" for i in range(len(seeds))}
        self.reads = [0, 0, 0]
        self.stop = threading.Event()

    def guard(self, fn, *args):
        try:
            fn(*args)
        except Exception as ex:   # noqa: BLE001
            self.errors.append(ex)

    def adder(self, t: int):
        rng = np.random.default_rng(100 + t)
        for i in range(ADDS):
            x = rng.normal(size=STORM_DIM).astype(np.float32)
            ext = f"a{t}_{i}"
            self.known.add(ext)
            self.e.add("chaos", ext, x, {"grp": i % 4})
            self.added[ext] = x

    def deleter(self):
        for i in range(DELETES):
            assert self.e.delete("chaos", f"seed{i}")
            self.deleted_at[f"seed{i}"] = time.monotonic()

    def patcher(self):
        for i in range(PATCHES):
            self.e.update_metadata("chaos", f"seed{200 + i % 100}",
                                   {"grp": 1, "patch": i})

    def reader(self, r: int):
        rng = np.random.default_rng(200 + r)
        B, filt = ((1, None), (8, None), (4, "grp = 1"))[r]
        while not self.stop.is_set():
            q = self.seeds[rng.integers(0, len(self.seeds), size=B)]
            t0 = time.monotonic()
            res = self.e.search("chaos", q, k=5, filter=filt)
            assert len(res) == B
            for hits in res:
                for h in hits:
                    assert h["id"] in self.known, h
                    assert np.isfinite(h["score"]), h
                    gone = self.deleted_at.get(h["id"])
                    assert gone is None or gone >= t0, \
                        f"{h['id']} deleted before the search began"
            self.reads[r] += 1

    def run(self, settle=None) -> None:
        writers = [threading.Thread(target=self.guard, args=(self.adder, t))
                   for t in range(ADDERS)]
        writers += [threading.Thread(target=self.guard, args=(f,))
                    for f in (self.deleter, self.patcher)]
        readers = [threading.Thread(target=self.guard, args=(self.reader, r))
                   for r in range(3)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        if settle is not None:
            settle()
        self.stop.set()
        for t in readers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in writers + readers)

    def check(self, e: Engine, label: str) -> None:
        """Every acknowledged add bit-equal, every acknowledged delete
        gone, every patch in place, and a live seed found first."""
        ids = sorted(self.added)
        assert [e.get("chaos", x)["id"] for x in ids] == ids, label
        np.testing.assert_array_equal(
            vectors_of(e, "chaos", ids),
            np.stack([self.added[x] for x in ids]), err_msg=label)
        for x in self.deleted_at:
            with pytest.raises(KeyError):
                e.get("chaos", x)
        meta = e.get("chaos", "seed299")["metadata"]
        assert (meta["grp"], meta["patch"]) == (1, 99), label
        assert e.search("chaos", self.seeds[250], k=1)[0][0]["id"] \
            == "seed250", label


@pytest.mark.parametrize("background", [False, True],
                         ids=["no_background", "background"])
def test_storm(background, tmp_path):
    """Adders, a deleter, a patcher and three readers at once, at fixed
    counts of writes; with the background thread, it snapshots and links
    during the storm (the test waits for one tick of each before it stops
    the readers), and the data survives close() and a reopen."""
    cfg = dict(BG_CONFIG, data_dir=str(tmp_path)) if background \
        else dict(start_background=False)
    e = Engine(EngineConfig(device="cpu", **cfg)).open()
    e.create_index("chaos", m=8, ef_construction=64)
    seeds = np.random.default_rng(0).normal(
        size=(STORM_SEEDS, STORM_DIM)).astype(np.float32)
    e.add_batch("chaos", [f"seed{i}" for i in range(STORM_SEEDS)], seeds,
                [{"grp": i % 4} for i in range(STORM_SEEDS)])
    ticks = {"save_snapshot": 0, "run_maintenance": 0}
    for name in ticks:      # count what the background thread runs
        def wrap(fn=getattr(e, name), name=name):
            def counted():
                if threading.current_thread() is e._bg:
                    ticks[name] += 1
                return fn()
            return counted
        setattr(e, name, wrap())

    def settle():           # one snapshot and one link tick, mid-storm
        t0 = time.monotonic()
        while min(ticks.values()) < 1 and time.monotonic() - t0 < 30:
            time.sleep(0.05)
    storm = Storm(e, seeds)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # more interleavings per operation
    try:
        with ErrorRecords() as errs:
            storm.run(settle if background else None)
            assert not storm.errors, storm.errors[:3]
            assert min(storm.reads) >= 1, storm.reads
            if background:
                assert min(ticks.values()) >= 1, ticks
            e.run_maintenance()
            assert not e.indexes["chaos"].index._unlinked
            storm.check(e, "after the storm")
            e.close()
    finally:
        sys.setswitchinterval(switch)
    assert not errs.records, errs.messages()
    if background:
        e2 = Engine(EngineConfig(device="cpu", data_dir=str(tmp_path),
                                 start_background=False)).open()
        try:
            storm.check(e2, "reopened")
        finally:
            e2.close()


def test_background_loop_survives_a_failed_tick(monkeypatch):
    """A failure in the background thread's run_maintenance is an ERROR
    record of the `kektordb` logger, which the logger check collects, and
    the loop goes on to its next tick."""
    e = Engine(EngineConfig(device="cpu", start_background=False,
                            maintenance_interval=0.0))
    calls = []
    real = e.run_maintenance

    def failing_once():
        calls.append(time.monotonic())
        if len(calls) == 1:
            raise RuntimeError("injected maintenance failure")
        return real()
    monkeypatch.setattr(e, "run_maintenance", failing_once)
    e.config.start_background = True
    with ErrorRecords() as errs:
        e.open()
        try:
            t0 = time.monotonic()
            while len(calls) < 2 and time.monotonic() - t0 < 30:
                time.sleep(0.05)
        finally:
            e.close()
    assert len(calls) >= 2, "the loop stopped after the failed tick"
    assert len(errs.records) == 1, errs.messages()
    rec = errs.records[0]
    assert rec.getMessage() == "background maintenance error"
    assert "injected maintenance failure" in errs.messages()[0]

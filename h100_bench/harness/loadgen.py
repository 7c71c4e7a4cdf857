"""Client processes that drive the served program for one window.

Each process is started with the `spawn` method and imports only numpy,
the standard library and, for an open loop, aiohttp's client; it never
touches the card. It connects to the server on 127.0.0.1, waits for the
window's start (`time.perf_counter` is CLOCK_MONOTONIC, one clock for
every process of the host), sends, records each request's due, send and
completion times, and keeps each answer's raw body. Once the window has
closed and every answer is in (or `drain_s` has passed), it decodes the
bodies with the mix's request builder and sends everything back. Where
the run gives them CPUs, the client processes keep to those, apart from
the serving process's.

- closed loop: each process sends its next request when the previous
  one has been answered, until the window closes; a request is due when
  it is sent.
- open loop: requests due at the times the parent drew, sent at those
  times whether or not earlier ones have been answered; latency counts
  from the due time, and how late each send was is recorded.
"""

from __future__ import annotations

import asyncio
import http.client
import os
import time
import traceback
from pathlib import Path

import numpy as np

HEADERS = {"Content-Type": "application/json"}


def _closed_loop(job, builder, out: list) -> None:
    rng = np.random.default_rng([job["seed"], job["proc"]])
    batch = int(job["mix"].get("batch", 1))
    n_pool = job["queries"].shape[0]
    conn = http.client.HTTPConnection("127.0.0.1", job["port"], timeout=600)
    end = job["t0"] + job["seconds"]
    while True:
        idx = rng.integers(0, n_pool, size=batch)
        body = builder.body(job["index"], job["queries"], job["texts"], idx,
                            job["mix"])
        now = time.perf_counter()
        if now < job["t0"]:
            time.sleep(job["t0"] - now)
        t_send = time.perf_counter()
        if t_send >= end:
            break
        try:
            conn.request("POST", builder.ROUTE, body=body, headers=HEADERS)
            resp = conn.getresponse()
            raw, status = resp.read(), resp.status
        except (OSError, http.client.HTTPException):
            raw, status = b"", -1
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", job["port"],
                                              timeout=600)
        out.append((t_send, t_send, time.perf_counter(), status, idx, raw))
    conn.close()


async def _open_loop(job, builder, bodies: list, out: list) -> None:
    import aiohttp

    url = f"http://127.0.0.1:{job['port']}{builder.ROUTE}"
    due = job["due"]
    idx = job["draws"]
    slot: list = [None] * len(due)

    async def one(session, j: int, t_due: float) -> None:
        t_send = time.perf_counter()
        try:
            async with session.post(url, data=bodies[j],
                                    headers=HEADERS) as r:
                raw, status = await r.read(), r.status
        except (aiohttp.ClientError, OSError, asyncio.TimeoutError):
            raw, status = b"", -1
        slot[j] = (t_due, t_send, time.perf_counter(), status, idx[j], raw)

    conn = aiohttp.TCPConnector(limit=0)
    timeout = aiohttp.ClientTimeout(total=job["seconds"] + job["drain_s"])
    async with aiohttp.ClientSession(connector=conn,
                                     timeout=timeout) as session:
        tasks = []
        for j, d in enumerate(due.tolist()):
            t_due = job["t0"] + d
            wait = t_due - time.perf_counter()
            if wait > 0:
                await asyncio.sleep(wait)
            tasks.append(asyncio.create_task(one(session, j, t_due)))
        if tasks:
            await asyncio.wait(tasks, timeout=job["drain_s"])
        for t in tasks:
            if not t.done():
                t.cancel()
    for j, rec in enumerate(slot):
        out.append(rec if rec is not None else
                   (job["t0"] + float(due[j]), np.nan, np.nan, -1, idx[j],
                    b""))


def _decode(job, builder, recs: list) -> dict:
    k = int(job["mix"]["k"])
    keep_score = job["mix"]["read"] == "hybrid"
    n = len(recs)
    t = np.array([r[:3] for r in recs], np.float64).reshape(n, 3)
    status = np.array([r[3] for r in recs], np.int64)
    ok = status == 200
    pools, rows, dists, scores = [], [], [], []
    for i, r in enumerate(recs):
        if not ok[i]:
            continue
        q = np.asarray(r[4], np.int64)
        try:
            rw, di, sc = builder.decode(r[5], q.size, k)
        except (ValueError, KeyError, TypeError, IndexError):
            ok[i] = False
            continue
        pools.append(q)
        rows.append(rw.astype(np.int32))
        dists.append(di.astype(np.float32))
        if keep_score:
            scores.append(sc)
    cat = (lambda xs, shape, dt: np.concatenate(xs) if xs
           else np.empty(shape, dt))
    return {"t_due": t[:, 0], "t_send": t[:, 1], "t_done": t[:, 2],
            "ok": ok, "status": status,
            "n_queries": np.array([np.size(r[4]) for r in recs], np.int64),
            "pool": cat(pools, (0,), np.int64),
            "rows": cat(rows, (0, k), np.int32),
            "dist": cat(dists, (0, k), np.float32),
            "score": cat(scores, (0, k), np.float64) if keep_score else None}


def client_main(conn) -> None:
    """Entry of one client process: takes its job from `Clients`, says
    "ready", and answers the "go" message (the window's start) with the
    decoded records. Exits quietly where the parent closes the pipe
    first."""
    try:
        job = conn.recv()
        if job.get("cpus"):
            os.sched_setaffinity(0, job["cpus"])
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "h100_bench_request", job["builder_path"])
        builder = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(builder)
        bodies = None
        if job["mix"]["loop"] == "open":
            import aiohttp  # noqa: F401  (imported before the window)
            bodies = [builder.body(job["index"], job["queries"],
                                   job["texts"], i, job["mix"])
                      for i in job["draws"]]
        conn.send("ready")
        job["t0"] = conn.recv()
        recs: list = []
        if job["mix"]["loop"] == "closed":
            _closed_loop(job, builder, recs)
        else:
            asyncio.run(_open_loop(job, builder, bodies, recs))
        t = time.perf_counter()
        out = _decode(job, builder, recs)
        out["decode_s"] = np.array([time.perf_counter() - t])
        conn.send(out)
    except (EOFError, BrokenPipeError):
        pass
    except Exception:  # noqa: BLE001 - reported to the parent
        try:
            conn.send({"error": traceback.format_exc()})
        except OSError:
            pass
    finally:
        conn.close()


def schedule(mix: dict, rate: float, seconds: float, n_pool: int,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """An open loop's arrivals: (due offsets [N] in seconds from the
    window's start, pool draws [N, batch]). N = rate x seconds, and the
    gaps are the N quantiles of the exponential distribution at that rate,
    in an order drawn from the seed: Poisson arrivals whose set of gaps is
    the same for every seed, scaled to fill the window. The mix's
    `arrivals` names the process; Poisson is the only one."""
    if mix.get("arrivals") != "poisson":
        raise ValueError(f"arrivals {mix.get('arrivals')!r}: only "
                         f"'poisson' is implemented")
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([seed, 1])
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
    draws = rng.integers(0, n_pool, size=(n, int(mix.get("batch", 1))))
    return due, draws


def split_cpus() -> tuple[list[int], list[int]] | None:
    """(the serving process's CPUs, the client processes' CPUs) out of
    those this process may use: the clients take the last whole core (all
    of its hardware threads), the server every other. None where that
    would leave the server fewer than two cores."""
    cores: dict[str, list[int]] = {}
    for c in sorted(os.sched_getaffinity(0)):
        try:
            sib = Path(f"/sys/devices/system/cpu/cpu{c}/topology/"
                       "thread_siblings_list").read_text().strip()
        except OSError:
            sib = str(c)
        cores.setdefault(sib, []).append(c)
    groups = sorted(cores.values())
    if len(groups) < 3:
        return None
    return sorted(c for g in groups[:-1] for c in g), groups[-1]


class Clients:
    """The client processes of one window. They are started first, so
    that their start overlaps the set-up; `send_job` then hands them
    their work once the server is up, and the CPUs `cpus` where given."""

    def __init__(self, mix: dict, cpus: list[int] | None = None):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.mix, self.cpus = mix, cpus
        self.conns, self.procs = [], []
        for _ in range(int(mix.get("processes", 1))):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=client_main, args=(child,),
                               daemon=True)
            proc.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(proc)

    def send_job(self, port: int, index: str, builder_path,
                 queries: np.ndarray, texts, seed: int, seconds: float,
                 rate: float | None = None, drain_s: float = 60.0) -> None:
        mix, n_proc = self.mix, len(self.procs)
        base = {"port": port, "index": index, "mix": mix,
                "builder_path": str(builder_path), "queries": queries,
                "texts": texts, "seed": seed, "seconds": seconds,
                "drain_s": drain_s, "cpus": self.cpus}
        if mix["loop"] == "open":
            due, draws = schedule(mix, rate, seconds, queries.shape[0],
                                  seed)
        for p, c in enumerate(self.conns):
            job = dict(base, proc=p)
            if mix["loop"] == "open":
                job["due"], job["draws"] = due[p::n_proc], draws[p::n_proc]
            c.send(job)

    def ready(self, timeout: float = 120.0) -> None:
        for c in self.conns:
            if not c.poll(timeout):
                raise TimeoutError("a client process did not start")
            msg = c.recv()
            if msg != "ready":
                raise RuntimeError(f"client failed to start: {msg}")

    def go(self, t0: float) -> None:
        for c in self.conns:
            c.send(t0)

    def collect(self, timeout: float) -> dict:
        """Every client's records, merged and ordered by due time."""
        parts = []
        self.recv_s = 0.0
        for c in self.conns:
            if not c.poll(timeout):
                raise TimeoutError("a client process did not finish")
            t = time.perf_counter()
            part = c.recv()
            self.recv_s += time.perf_counter() - t
            if "error" in part:
                raise RuntimeError(f"client failed:\n{part['error']}")
            parts.append(part)
        self.close()
        out = {}
        for key in parts[0]:
            vals = [p[key] for p in parts]
            out[key] = None if vals[0] is None else np.concatenate(vals)
        # answers stay in their requests' order: reorder requests and
        # their queries together
        order = np.argsort(out["t_due"], kind="stable")
        starts = np.concatenate([[0], np.cumsum(
            np.where(out["ok"], out["n_queries"], 0))])
        q_order = np.concatenate(
            [np.arange(starts[i], starts[i + 1]) for i in order]
            + [np.empty(0, np.int64)])
        for key in ("t_due", "t_send", "t_done", "ok", "status",
                    "n_queries"):
            out[key] = out[key][order]
        for key in ("pool", "rows", "dist", "score"):
            if out[key] is not None:
                out[key] = out[key][q_order]
        return out

    def close(self) -> None:
        """Close the pipes (a client still waiting for its job or its
        start then exits), then wait for every process."""
        for c in self.conns:
            c.close()
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)

"""The batched search's `query_vectors_b64` bodies, decoded natively from
the raw body (`server/http.py`: `search_body`, `b64_skeleton`,
`host_native.b64decode`), against the path that parses the whole body with
`json.loads` and decodes with `base64.b64decode`, which the test takes by
switching the skeleton off.

For each body of the table both paths give the same status and the same
answer or error text, and the native path moves the counter the table
names: `http.queries_b64.native` where the value is canonical standard
base64 and the skeleton stands for the body, `http.queries_b64.fallback`
where the body has the key but not so, neither where it has no key.
"""

import asyncio
import base64
import json

import numpy as np
import pytest

from kektordb_tpu_torch import tracing
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.server import http as server_http
from kektordb_tpu_torch.server import make_app

DIM, N = 8, 64
NATIVE, FALLBACK = "http.queries_b64.native", "http.queries_b64.fallback"
Q = np.random.default_rng(11).standard_normal((4, DIM)).astype("<f4")


def _b64(q) -> str:
    return base64.b64encode(np.asarray(q, "<f4").tobytes()).decode()


def _dumps(**fields) -> bytes:
    return json.dumps({"index_name": "T", "k": 3, **fields}).encode()


def _batch(rows, **extra) -> dict:
    return {"query_vectors_b64": _b64(Q[:rows]), "query_shape": [rows, DIM],
            **extra}


def _with_slash() -> bytes:
    # the first query batch whose base64 holds a '/', sent as JSON's "\/"
    for seed in range(100):
        text = _b64(np.random.default_rng(seed).standard_normal((2, DIM)))
        if "/" in text:
            body = _dumps(query_vectors_b64=text, query_shape=[2, DIM])
            return body.replace(b"/", b"\\/")
    raise AssertionError("no batch with a '/'")


def _twice(first: str, second: str) -> bytes:
    return (b'{"index_name": "T", "k": 3, "query_vectors_b64": "'
            + first.encode() + b'", "query_shape": [2, 8], '
            b'"query_vectors_b64": "' + second.encode() + b'"}')


B64_A, B64_B = _b64(Q[:2]), _b64(Q[2:])

# id -> (raw body, the counter the native path moves, or None)
BODIES = {
    # 4 * 8 * rows bytes: 0, 1 and 2 padding characters
    "pad0": (_dumps(**_batch(3)), NATIVE),
    "pad1": (_dumps(**_batch(1)), NATIVE),
    "pad2": (_dumps(**_batch(2)), NATIVE),
    "columnar-b64-wire": (_dumps(**_batch(4, columnar=True, wire="b64")),
                          NATIVE),
    "columnar": (_dumps(**_batch(4, columnar=True)), NATIVE),
    "escaped-slash": (_with_slash(), FALLBACK),
    "newline-wrapped": (_dumps(
        query_vectors_b64=base64.encodebytes(
            np.tile(Q, (4, 1)).tobytes()).decode(),
        query_shape=[16, DIM]), FALLBACK),
    "url-safe": (_dumps(
        query_vectors_b64=base64.urlsafe_b64encode(Q.tobytes()).decode(),
        query_shape=[4, DIM]), FALLBACK),
    "key-twice": (_twice(B64_A, B64_B), FALLBACK),
    "key-twice-swapped": (_twice(B64_B, B64_A), FALLBACK),
    "key-text-in-filter": (_dumps(filter="query_vectors_b64 = 1",
                                  **_batch(2)), NATIVE),
    "quoted-key-text-in-filter": (_dumps(
        filter='note = "query_vectors_b64"', **_batch(2)), FALLBACK),
    "placeholder-in-body": (_dumps(note=server_http.B64_HOLE, **_batch(2)),
                            FALLBACK),
    "placeholder-as-value": (_dumps(query_vectors_b64=server_http.B64_HOLE,
                                    query_shape=[1, DIM]), FALLBACK),
    "key-in-nested-object": (_dumps(graph_filter={
        "query_vectors_b64": B64_A}, query_vector=Q[0].tolist()), FALLBACK),
    "null-value": (_dumps(query_vectors_b64=None,
                          query_vector=Q[0].tolist()), FALLBACK),
    "empty-value": (_dumps(query_vectors_b64="", query_shape=[1, DIM]),
                    NATIVE),
    "non-object": (b"[" + _dumps(**_batch(2)) + b"]", FALLBACK),
    "missing-shape": (_dumps(query_vectors_b64=B64_A), NATIVE),
    "shape-mismatch": (_dumps(query_vectors_b64=B64_A,
                              query_shape=[3, DIM]), NATIVE),
    "length-not-4k": (_dumps(query_vectors_b64=base64.b64encode(
        b"\x00" * 6).decode(), query_shape=[1, 1]), NATIVE),
    "missing-index": (json.dumps(_batch(2)).encode(), NATIVE),
    "invalid-json": (_dumps(**_batch(2))[:-1] + b", }", FALLBACK),
    "control-char-no-index": (json.dumps(
        {"query_vectors_b64": "QUJD" + "\x01" + "QUJ",
         "query_shape": [1, DIM]}).encode().replace(b"\\u0001", b"\x01"),
        FALLBACK),
    "plain-query-vectors": (_dumps(query_vectors=Q[:2].tolist()), None),
    "single-query": (_dumps(query_vector=Q[0].tolist()), None),
}


@pytest.fixture(scope="module")
def engine():
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    e.create_index("T", serve_mode="scan")
    rng = np.random.default_rng(7)
    e.add_batch("T", [str(i) for i in range(N)],
                rng.standard_normal((N, DIM)).astype(np.float32),
                [{"grp": i % 2} for i in range(N)])
    yield e
    e.close()


def _post(engine, raw: bytes) -> tuple[int, bytes]:
    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        async with TestClient(TestServer(make_app(engine))) as client:
            r = await client.post(
                "/vector/actions/search", data=raw,
                headers={"Content-Type": "application/json"})
            return r.status, await r.read()

    return asyncio.run(main())


def _moved(engine, raw: bytes):
    before = tracing.counters()
    status, answer = _post(engine, raw)
    after = tracing.counters()
    moved = {k for k in (NATIVE, FALLBACK)
             if after.get(k, 0) != before.get(k, 0)}
    return status, answer, moved


@pytest.mark.parametrize("case", list(BODIES))
def test_native_path_answers_as_the_whole_body_parse(case, engine,
                                                     monkeypatch):
    raw, counter = BODIES[case]
    status, answer, moved = _moved(engine, raw)
    assert moved == ({counter} if counter else set()), (case, moved)
    with monkeypatch.context() as m:
        m.setattr(server_http, "b64_skeleton", lambda raw, at: None)
        want_status, want = _post(engine, raw)
    assert (status, answer) == (want_status, want), case
    if counter == NATIVE and case.startswith(("pad", "columnar")):
        assert status == 200, answer


def test_metrics_export_the_counters(engine):
    from aiohttp.test_utils import TestClient, TestServer

    async def main():
        async with TestClient(TestServer(make_app(engine))) as client:
            for raw, _ in (BODIES["pad0"], BODIES["newline-wrapped"]):
                r = await client.post(
                    "/vector/actions/search", data=raw,
                    headers={"Content-Type": "application/json"})
                assert r.status == 200, await r.text()
            return await (await client.get("/metrics")).text()

    text = asyncio.run(main())
    counts = tracing.counters()
    for name in (NATIVE, FALLBACK):
        series = "kektordb_" + name.replace(".", "_") + "_total"
        assert f"{series} {counts[name]}" in text, series

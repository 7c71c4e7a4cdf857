"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped (the CPU), everything else runs
as on the card, with `Engine.search` of the program wrapped to plant one
fault where the answer is produced:

- an answer altered: one hit's id replaced by another row's;
- half of the batch left out: the first half searched, its answers
  given to the second half too (batched requests only);
- the state returned unchanged: each search answers with the previous
  search's answer;
- a distance altered by one part in a thousand;
- a wrong row that looks right: every third hybrid answer's last hit
  replaced by a row outside the answer, with no distance (as a text-only
  hit has none) and the score it had.

A cell on one card has no exchange between cards to leave out.
"""

import copy

import numpy as np
import pytest
from bench_small import SMALL

from harness import spec as speclib
from harness.cell import run_cell
from kektordb_tpu_torch.engine.engine import Engine

_search = Engine.search


def _alter_id(hits):
    if isinstance(hits, dict):
        ids = hits["ids"]
        ids[0][0] = ids[0][-1] if ids[0][-1] != ids[0][0] else "0"
        ids[0][-1] = "1" if ids[0][0] != "1" else "2"
    else:
        hits[0][0]["id"] = str((int(hits[0][0]["id"]) + 7) % 1000)
    return hits


def _scale_dist(hits):
    if isinstance(hits, dict):
        d = hits["distances"]
        if isinstance(d, np.ndarray):
            hits["distances"] = d * np.float32(1.001)
        else:
            hits["distances"] = [[x * 1.001 for x in row] for row in d]
    else:
        for h in hits[0]:
            if h.get("distance") is not None:
                h["distance"] *= 1.001
    return hits


def altered(self, index, query, *a, **kw):
    return _alter_id(_search(self, index, query, *a, **kw))


def distance_altered(self, index, query, *a, **kw):
    return _scale_dist(_search(self, index, query, *a, **kw))


def half_batch(self, index, query, *a, **kw):
    q = np.atleast_2d(np.asarray(query, np.float32))
    half = (q.shape[0] + 1) // 2
    q = np.concatenate([q[:half], q[:half]])[:q.shape[0]]
    return _search(self, index, q, *a, **kw)


_last: dict = {}


def stale(self, index, query, *a, **kw):
    out = _search(self, index, query, *a, **kw)
    prev = _last.get(id(self))
    _last[id(self)] = copy.deepcopy(out)
    if prev is not None and type(prev) is type(out) \
            and (len(prev) == len(out) if isinstance(out, list)
                 else len(prev["ids"]) == len(out["ids"])):
        return prev
    return out


_calls: dict = {}


def wrong_row(self, index, query, *a, **kw):
    out = _search(self, index, query, *a, **kw)
    n = _calls[id(self)] = _calls.get(id(self), 0) + 1
    if n % 3 == 0 and isinstance(out, list):
        for hits in out:
            taken = {int(h["id"]) for h in hits}
            hits[-1]["id"] = str(min(set(range(len(taken) + 1)) - taken))
            hits[-1]["distance"] = None
    return out


FAULTS = {"altered": altered, "distance": distance_altered,
          "half_batch": half_batch, "stale": stale, "wrong_row": wrong_row}
# a mix of one query a request has no half batch to leave out; the wrong
# row is planted where the answers carry text-only hits
SPEC = speclib.load_spec(waiting=True)
MIX = {w: speclib.cell(SPEC, w)["mix"] for w in SMALL}
CASES = [(w, f) for w in sorted(SMALL) for f in FAULTS
         if (f != "half_batch" or SMALL[w]["mix"].get("batch", 1) > 1)
         and (f != "wrong_row" or MIX[w]["read"] == "hybrid")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    monkeypatch.setattr(Engine, "search", FAULTS[fault])
    result, lines = run_cell(workload, 4242, 2.0, False, "cpu",
                             overrides=SMALL[workload], spec=SPEC)
    assert not result["correct"], lines

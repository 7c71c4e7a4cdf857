"""Cognitive Gardener — the background "think" daemon.

Reference: pkg/cognitive/gardener.go (modes basic/advanced/meta, adaptive
scheduling :150-190, 11 detectors, reflections as pinned graph nodes,
volatile-belief resolution, session summarization, user profiling).

Detectors (deterministic-first; an optional LLM client upgrades
contradiction detection and consolidation summaries — with no client the
deterministic path runs, matching the reference's nil-LLM tests
gardener_race_test.go:52):

  1  knowledge gaps        similar-but-unlinked memory pairs (:2295)
  2  importance shifts     access-count outliers (:1471)
  3  sentiment shifts      lexicon scoring drift (:2568, sentiment_lexicon.go)
  4  centrality shifts     graph-degree outliers (:2677)
  5  forgetting patterns   low retention + never accessed (:2755)
  6  consolidation         redundant high-similarity clusters, episodic→
                           semantic promotion (:781-1288)
  7  contradictions        negation heuristic / LLM (:1311)
  8  user preferences      like/prefer/hate statements (:2430)
  9  repeated failures     recurring failure mentions (:2818)
  10 knowledge evolution   long evolves_from chains (:2977)
  11 cross-validation      conflicting reflections (meta mode, :3145)
"""

from __future__ import annotations

import json
import logging
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..engine import fusion
from .llm import clean_llm_json

log = logging.getLogger("kektordb.gardener")

REFLECTION_TYPE = "reflection"

POSITIVE = frozenset("""good great excellent love like enjoy happy success
wonderful amazing perfect fast easy helpful fixed works solved ottimo buono
bene felice perfetto risolto funziona""".split())
NEGATIVE = frozenset("""bad terrible hate dislike angry fail failure broken
slow hard bug error crash wrong annoying cattivo male errore rotto lento
sbagliato fallito""".split())

_PREF_RE = re.compile(
    r"\b(i|user)\s+(really\s+)?(like|love|prefer|hate|dislike|avoid)s?\b",
    re.IGNORECASE)
_FAIL_RE = re.compile(r"\b(fail(ed|ure)?|error|crash(ed)?|broken|bug)\b",
                      re.IGNORECASE)
_NEG_RE = re.compile(r"\b(not|never|no longer|isn't|doesn't|won't|can't)\b",
                     re.IGNORECASE)


@dataclass
class GardenerConfig:
    """Adaptive scheduling (gardener.go:150-190)."""
    mode: str = "basic"                 # basic | advanced | meta
    interval: float = 300.0
    early_think_writes: int = 50       # early think after N writes
    similarity_threshold: float = 0.88  # gap/consolidation similarity
    consolidation_min_cluster: int = 3
    max_reflections_per_cycle: int = 10


class Gardener:
    def __init__(self, engine, llm=None, config: Optional[GardenerConfig] = None,
                 embedder=None):
        self.engine = engine
        self.llm = llm
        self.embedder = embedder
        self.config = config or GardenerConfig()
        self._writes_since_think = 0
        self._last_think: dict[str, float] = {}
        self._cycles = 0
        engine.events.on(self._on_event,
                         types={"vector.add", "vector.update"})

    def _on_event(self, ev) -> None:
        self._writes_since_think += 1

    # ------------------------------------------------------------- status

    def status(self) -> dict:
        return {"enabled": True, "mode": self.config.mode,
                "cycles": self._cycles,
                "writes_since_think": self._writes_since_think,
                "last_think": dict(self._last_think)}

    def should_think(self, index: str) -> bool:
        last = self._last_think.get(index, 0.0)
        if self._writes_since_think >= self.config.early_think_writes:
            return True
        return time.time() - last >= self.config.interval

    # -------------------------------------------------------------- think

    def think(self, index: str) -> dict:
        """One full cycle over an index; stores new reflections as pinned
        graph nodes (gardener.go:191,415)."""
        e = self.engine
        if index not in e.indexes:
            return {"reflections": 0, "detectors": {}}
        h = e._handle(index)
        if hasattr(h.index, "flush"):
            h.index.flush()
        mems = self._memories(h)
        found: list[dict] = []
        detectors = {
            "knowledge_gaps": self._detect_gaps,
            "importance_shifts": self._detect_importance,
            "sentiment_shifts": self._detect_sentiment,
            "centrality_shifts": self._detect_centrality,
            "forgetting": self._detect_forgetting,
            "consolidation": self._detect_consolidation,
            "contradictions": self._detect_contradictions,
            "user_preferences": self._detect_preferences,
            "repeated_failures": self._detect_failures,
            "knowledge_evolution": self._detect_evolution,
        }
        counts = {}
        for name, det in detectors.items():
            try:
                items = det(index, h, mems)
            except Exception:
                log.exception("detector %s failed", name)
                items = []
            counts[name] = len(items)
            found.extend(items)
        if self.config.mode == "meta":
            meta_items = self._cross_validate(index)
            counts["cross_validation"] = len(meta_items)
            found.extend(meta_items)

        stored = 0
        for refl in found[: self.config.max_reflections_per_cycle]:
            if self._store_reflection(index, refl):
                stored += 1
        if self.config.mode in ("advanced", "meta"):
            # epistemic adjudication of contested beliefs flagged by the
            # contradiction detector (gardener.go:3277-3599)
            try:
                resolved = self.resolve_volatile_beliefs(index)
                counts["belief_resolution"] = len(resolved)
                stored += len(resolved)
            except Exception:
                log.exception("belief resolution failed")
        self._writes_since_think = 0
        self._last_think[index] = time.time()
        self._cycles += 1
        return {"reflections": stored, "detectors": counts}

    # ------------------------------------------------------- reflections

    def reflections(self, index: str,
                    include_resolved: bool = False) -> list[dict]:
        e = self.engine
        if index not in e.indexes:
            return []
        h = e._handle(index)
        out = []
        for row, meta in h.meta.direct.items():
            if meta.get("type") != REFLECTION_TYPE:
                continue
            if not include_resolved and meta.get("resolved"):
                continue
            ext = h.index.ids.row_to_ext[row] \
                if row < len(h.index.ids.row_to_ext) else None
            if ext:
                out.append({"id": ext, **{k: v for k, v in meta.items()
                                          if not k.startswith("_")}})
        return out

    def resolve(self, index: str, reflection_id: str,
                resolution: Optional[str] = None) -> bool:
        try:
            patch = {"resolved": True,
                     "resolved_at": time.time()}
            if resolution:
                patch["resolution"] = resolution
            self.engine.update_metadata(index, reflection_id, patch)
            return True
        except KeyError:
            return False

    def _store_reflection(self, index: str, refl: dict) -> bool:
        """Dedup by (kind, subject); store pinned (gardener reflections are
        pinned graph nodes)."""
        key = f"{refl['kind']}:{refl.get('subject', '')}"
        for existing in self.reflections(index, include_resolved=True):
            if f"{existing.get('kind')}:{existing.get('subject', '')}" == key:
                return False
        rid = f"refl_{uuid.uuid4().hex[:10]}"
        vec = (self.embedder.embed(refl["content"])
               if self.embedder is not None
               else np.zeros(8, np.float32))
        dim = self.engine.indexes[index].index.dim or None
        if dim and vec.shape[0] != dim:
            vec = np.zeros(dim, np.float32)
        self.engine.add(index, rid, vec, {
            "type": REFLECTION_TYPE, "content": refl["content"],
            "kind": refl["kind"], "subject": refl.get("subject", ""),
            "severity": refl.get("severity", "info"),
            "resolved": False, "_pinned": True})
        for target in refl.get("links", []):
            try:
                self.engine.link(index, rid, "about", target)
            except KeyError:
                pass
        return True

    # --------------------------------------------------------- detectors

    def _memories(self, h) -> list[dict]:
        out = []
        for row, meta in h.meta.direct.items():
            if meta.get("type") in (REFLECTION_TYPE, "entity"):
                continue
            ext = h.index.ids.row_to_ext[row] \
                if row < len(h.index.ids.row_to_ext) else None
            if ext is None:
                continue
            out.append({"id": ext, "row": row, "meta": meta,
                        "content": str(meta.get("content", ""))})
        return out

    def _sim_matrix(self, h, rows: list[int]) -> Optional[np.ndarray]:
        if len(rows) < 2:
            return None
        V = h.index.state.vectors[np.asarray(rows)].float().cpu().numpy()
        norms = np.linalg.norm(V, axis=1, keepdims=True)
        ok = norms[:, 0] > 1e-9
        Vn = np.where(norms > 1e-9, V / np.maximum(norms, 1e-9), 0.0)
        S = Vn @ Vn.T
        S[~ok, :] = 0.0
        S[:, ~ok] = 0.0
        np.fill_diagonal(S, 0.0)
        return S

    def _detect_gaps(self, index, h, mems) -> list[dict]:
        """Similar but unlinked (gardener.go:2295)."""
        S = self._sim_matrix(h, [m["row"] for m in mems[:512]])
        if S is None:
            return []
        out = []
        thr = self.config.similarity_threshold
        ii, jj = np.nonzero(np.triu(S, 1) >= thr)
        for i, j in list(zip(ii, jj))[:20]:
            a, b = mems[i], mems[j]
            if any(x["target"] == b["id"]
                   for x in self.engine.get_edges(index, a["id"])):
                continue
            out.append({
                "kind": "knowledge_gap", "subject": f"{a['id']}|{b['id']}",
                "severity": "info", "links": [a["id"], b["id"]],
                "content": f"Memories '{a['id']}' and '{b['id']}' are "
                           f"semantically close (sim={S[i, j]:.2f}) but not "
                           "linked — consider connecting them."})
        return out

    def _detect_importance(self, index, h, mems) -> list[dict]:
        counts = np.array([float(m["meta"].get(fusion.ACCESS_COUNT_KEY) or 0)
                           for m in mems])
        if counts.size < 5 or counts.max() == 0:
            return []
        thr = max(np.percentile(counts, 95), 3)
        out = []
        for m, c in zip(mems, counts):
            if c >= thr and not m["meta"].get(fusion.PINNED_KEY):
                out.append({
                    "kind": "importance_shift", "subject": m["id"],
                    "links": [m["id"]],
                    "content": f"Memory '{m['id']}' is accessed far more "
                               f"than its peers ({int(c)} times) — consider "
                               "pinning or promoting it."})
        return out[:5]

    def _sentiment(self, text: str) -> float:
        words = re.findall(r"[a-zàèìòù']+", text.lower())
        if not words:
            return 0.0
        pos = sum(w in POSITIVE for w in words)
        neg = sum(w in NEGATIVE for w in words)
        return (pos - neg) / max(pos + neg, 1)

    def _detect_sentiment(self, index, h, mems) -> list[dict]:
        by_subject: dict[str, list[tuple[float, float]]] = {}
        for m in mems:
            subj = m["meta"].get("subject") or m["meta"].get("topic")
            if not subj:
                continue
            ts = fusion._parse_ts(m["meta"].get(fusion.CREATED_KEY)) or 0.0
            by_subject.setdefault(str(subj), []).append(
                (ts, self._sentiment(m["content"])))
        out = []
        for subj, series in by_subject.items():
            if len(series) < 4:
                continue
            series.sort()
            half = len(series) // 2
            early = np.mean([s for _, s in series[:half]])
            late = np.mean([s for _, s in series[half:]])
            if abs(late - early) >= 1.0:
                out.append({
                    "kind": "sentiment_shift", "subject": subj,
                    "content": f"Sentiment about '{subj}' shifted from "
                               f"{early:+.2f} to {late:+.2f} over time."})
        return out

    def _detect_centrality(self, index, h, mems) -> list[dict]:
        degrees = []
        for m in mems:
            deg = len(self.engine.get_edges(index, m["id"])) + \
                len(self.engine.get_incoming_edges(index, m["id"]))
            degrees.append(deg)
        if not degrees or max(degrees) < 5:
            return []
        thr = max(np.percentile(degrees, 95), 5)
        out = []
        for m, d in zip(mems, degrees):
            if d >= thr:
                out.append({
                    "kind": "centrality_shift", "subject": m["id"],
                    "links": [m["id"]],
                    "content": f"'{m['id']}' became a graph hub "
                               f"({d} connections) — it may deserve an "
                               "entity node or summary artifact."})
        return out[:3]

    def _detect_forgetting(self, index, h, mems) -> list[dict]:
        mem_cfg = self.engine.indexes[index].memory
        if not mem_cfg.enabled:
            return []
        now = time.time()
        fading = []
        for m in mems:
            if m["meta"].get(fusion.PINNED_KEY):
                continue
            r = fusion.decay_factor(m["meta"], mem_cfg, now)
            if r < 0.2 and not m["meta"].get(fusion.ACCESS_COUNT_KEY):
                fading.append(m["id"])
        if len(fading) < 3:
            return []
        return [{
            "kind": "forgetting_pattern", "subject": f"{len(fading)} fading",
            "links": fading[:5],
            "content": f"{len(fading)} memories have decayed below 20% "
                       "retention without ever being accessed — candidates "
                       "for consolidation or deletion."}]

    def _detect_consolidation(self, index, h, mems) -> list[dict]:
        """Redundant clusters + episodic→semantic promotion
        (gardener.go:781-1288)."""
        sub = mems[:512]
        S = self._sim_matrix(h, [m["row"] for m in sub])
        if S is None:
            return []
        thr = self.config.similarity_threshold
        seen: set[int] = set()
        out = []
        for i in range(len(sub)):
            if i in seen:
                continue
            cluster = [i] + [j for j in np.nonzero(S[i] >= thr)[0]
                             if j not in seen]
            if len(cluster) >= self.config.consolidation_min_cluster:
                seen.update(cluster)
                ids = [sub[j]["id"] for j in cluster]
                episodic = [sub[j] for j in cluster
                            if sub[j]["meta"].get(fusion.LAYER_KEY)
                            == "episodic"]
                promote = (" Promote the consolidated memory to the "
                           "semantic layer." if len(episodic) >= 2 else "")
                summary = None
                if self.llm is not None:
                    summary = self._llm_consolidate(
                        [sub[j]["content"] for j in cluster])
                out.append({
                    "kind": "consolidation", "subject": ids[0],
                    "links": ids[:5],
                    "content": (summary or
                                f"{len(ids)} near-duplicate memories "
                                f"({', '.join(ids[:4])}…) could be "
                                f"consolidated into one.") + promote})
        return out[:3]

    def _llm_consolidate(self, contents: list[str]) -> Optional[str]:
        try:
            resp = self.llm.chat(
                "You consolidate redundant memories. Reply with one "
                "sentence that preserves all facts.",
                "\n".join(f"- {c[:300]}" for c in contents[:6]))
            return resp.strip()[:500] or None
        except Exception:
            return None

    def _detect_contradictions(self, index, h, mems) -> list[dict]:
        """Negation heuristic between similar pairs; LLM verdict when
        available (gardener.go:1311)."""
        sub = mems[:256]
        S = self._sim_matrix(h, [m["row"] for m in sub])
        if S is None:
            return []
        out = []
        ii, jj = np.nonzero(np.triu(S, 1) >= 0.8)
        for i, j in list(zip(ii, jj))[:30]:
            a, b = sub[i], sub[j]
            neg_a = bool(_NEG_RE.search(a["content"]))
            neg_b = bool(_NEG_RE.search(b["content"]))
            suspicious = neg_a != neg_b
            if suspicious and self.llm is not None:
                verdict = self._llm_contradiction(a["content"], b["content"])
                if verdict is False:
                    continue
            if suspicious:
                out.append({
                    "kind": "contradiction",
                    "subject": f"{a['id']}|{b['id']}",
                    "severity": "warning", "links": [a["id"], b["id"]],
                    "content": f"'{a['id']}' and '{b['id']}' describe the "
                               "same topic but one negates it — they may "
                               "contradict each other."})
        return out[:5]

    def _llm_contradiction(self, a: str, b: str) -> Optional[bool]:
        try:
            resp = self.llm.chat(
                "Do these two statements contradict each other? Reply with "
                'JSON {"contradicts": true/false}.',
                f"A: {a[:400]}\nB: {b[:400]}")
            parsed = clean_llm_json(resp)
            if isinstance(parsed, dict):
                return bool(parsed.get("contradicts"))
        except Exception:
            pass
        return None

    def _detect_preferences(self, index, h, mems) -> list[dict]:
        prefs = [m for m in mems if _PREF_RE.search(m["content"])]
        out = []
        for m in prefs[:5]:
            if m["meta"].get("_preference_noted"):
                continue
            out.append({
                "kind": "user_preference", "subject": m["id"],
                "links": [m["id"]],
                "content": f"'{m['id']}' states a user preference: "
                           f"\"{m['content'][:140]}\" — consider adding it "
                           "to the user profile."})
        return out

    def _detect_failures(self, index, h, mems) -> list[dict]:
        fails = [m for m in mems if _FAIL_RE.search(m["content"])]
        if len(fails) < 3:
            return []
        # group by most-common non-stopword token among failure memories
        from collections import Counter
        from ..text.analyzer import analyze
        counter = Counter()
        for m in fails:
            counter.update(set(analyze(m["content"])))
        counter.pop("fail", None)
        counter.pop("error", None)
        common = [w for w, c in counter.most_common(3) if c >= 3]
        if not common:
            return []
        return [{
            "kind": "repeated_failure", "subject": common[0],
            "links": [m["id"] for m in fails[:5]],
            "content": f"{len(fails)} memories mention failures around "
                       f"'{common[0]}' — a recurring problem worth a "
                       "dedicated fix or runbook."}]

    def _detect_evolution(self, index, h, mems) -> list[dict]:
        out = []
        for m in mems[:200]:
            chain = self.engine.evolution_chain(index, m["id"], max_len=10)
            if len(chain) >= 4:
                out.append({
                    "kind": "knowledge_evolution", "subject": chain[-1],
                    "links": chain[:5],
                    "content": f"Memory lineage {' → '.join(chain[:5])} has "
                               f"{len(chain)} generations — the topic is "
                               "evolving rapidly."})
        return out[:2]

    def _cross_validate(self, index) -> list[dict]:
        """Meta mode: reflections that disagree (gardener.go:3145)."""
        refls = self.reflections(index)
        by_subject: dict[str, list[dict]] = {}
        for r in refls:
            for part in str(r.get("subject", "")).split("|"):
                if part:
                    by_subject.setdefault(part, []).append(r)
        out = []
        for subj, rs in by_subject.items():
            kinds = {r["kind"] for r in rs}
            if "consolidation" in kinds and "contradiction" in kinds:
                out.append({
                    "kind": "cross_validation", "subject": subj,
                    "severity": "warning",
                    "content": f"Reflections about '{subj}' disagree: it is "
                               "flagged both as duplicate (consolidate) and "
                               "as contradictory — resolve the "
                               "contradiction first."})
        return out

    # ----------------------------------------------------- user profiling

    def build_user_profile(self, user_id: str, index: str) -> dict:
        """Deterministic profile from preference memories
        (gardener.go:1681-2172); LLM refinement optional."""
        h = self.engine._handle(index)
        likes, dislikes = [], []
        for m in self._memories(h):
            if m["meta"].get("user_id") not in (None, user_id):
                continue
            mm = _PREF_RE.search(m["content"])
            if not mm:
                continue
            verb = mm.group(3).lower()
            tail = m["content"][mm.end():].strip().split(".")[0][:60]
            (dislikes if verb in ("hate", "dislike", "avoid")
             else likes).append(tail)
        prof = {"user_id": user_id,
                "expertise_areas": likes[:5],
                "dislikes": dislikes[:5],
                "confidence": min(0.2 * (len(likes) + len(dislikes)), 1.0),
                "last_updated": int(time.time())}
        if self.llm is not None:
            try:
                resp = self.llm.chat(
                    "Summarize this user's communication style in JSON "
                    '{"communication_style": "...", "language": "..."}.',
                    json.dumps(prof))
                extra = clean_llm_json(resp)
                if isinstance(extra, dict):
                    prof.update({k: v for k, v in extra.items()
                                 if k in ("communication_style", "language",
                                          "response_length")})
            except Exception:
                pass
        self.engine.kv_set(f"profile:{user_id}", json.dumps(prof))
        return prof

    # ------------------------------------------- executable consolidation
    # (the reference's advanced mode doesn't just DESCRIBE consolidation,
    # it performs it: gardener.go:781-1288 merge flow)

    def consolidate_cluster(self, index: str, ids: list[str],
                            summary: Optional[str] = None,
                            promote: bool = True) -> Optional[str]:
        """Merge near-duplicate memories into one consolidated node:
        new semantic-layer memory + 'consolidates' edges, members marked
        historical (their decay accelerates; search prefers the merged
        node). Returns the new memory id."""
        e = self.engine
        h = e._handle(index)
        members = []
        for mid in ids:
            row = h.index.ids.get(mid)
            if row is not None:
                meta = h.meta.get(row) or {}
                members.append((mid, meta))
        if len(members) < 2:
            return None
        contents = [str(m.get("content", "")) for _, m in members]
        if summary is None and self.llm is not None:
            summary = self._llm_consolidate(contents)
        if not summary:
            # deterministic merge: longest content carries, others append
            uniq = list(dict.fromkeys(c for c in contents if c))
            summary = " ".join(uniq)[:800]
        cid = f"cons_{uuid.uuid4().hex[:10]}"
        vec = self._embed_for_index(h, summary)
        if vec is None:
            # centroid of member vectors
            vecs = [h.index.get_vector(mid) for mid, _ in members]
            vecs = [v for v in vecs if v is not None]
            if not vecs:
                return None
            vec = np.mean(vecs, axis=0)
        meta = {"content": summary, "type": "memory",
                "consolidated_from": [mid for mid, _ in members],
                "_pinned": True}
        if promote:
            meta[fusion.LAYER_KEY] = "semantic"
        e.add(index, cid, np.asarray(vec, np.float32), meta)
        for mid, _ in members:
            e.link(index, cid, "consolidates", mid, inverse="consolidated_by")
            try:
                e.update_metadata(index, mid, {"_is_historical": True,
                                               "_consolidated_into": cid})
            except KeyError:
                pass
        return cid

    def _embed_for_index(self, h, text: str) -> Optional[np.ndarray]:
        """Embed only when the embedder's dimension matches the index —
        otherwise the caller falls back to a member-vector centroid."""
        if self.embedder is None:
            return None
        dim = getattr(h.index, "dim", 0)
        if dim and getattr(self.embedder, "dim", dim) != dim:
            return None
        v = self.embedder.embed(text)
        if dim and v.shape[-1] != dim:
            return None
        return v

    def apply_reflection(self, index: str, reflection_id: str) -> dict:
        """Execute the action a reflection proposes (consolidation today;
        other kinds resolve with a note). Auto-resolves the reflection."""
        h = self.engine._handle(index)
        row = h.index.ids.get(reflection_id)
        if row is None:
            raise KeyError(f"no such reflection: {reflection_id}")
        meta = h.meta.get(row) or {}
        kind = meta.get("kind")
        if kind == "consolidation":
            # members are linked as "about" edges, not metadata
            links = [ed["target"] for ed in
                     self.engine.get_edges(index, reflection_id,
                                           relation="about")]
            cid = self.consolidate_cluster(index, links)
            self.resolve(index, reflection_id,
                         f"consolidated into {cid}" if cid
                         else "no members to merge")
            return {"action": "consolidated", "new_id": cid}
        self.resolve(index, reflection_id, "acknowledged")
        return {"action": "resolved"}

    # -------------------------------------------- volatile-belief resolution
    # (gardener.go:3277-3599: epistemic assessment -> LLM adjudication)

    def resolve_volatile_beliefs(self, index: str,
                                 max_nodes: int = 8) -> list[dict]:
        """Assess contradiction-flagged memories with the epistemic engine;
        contested/volatile ones get an adjudication reflection (LLM verdict
        when available, otherwise evidence-weighted recommendation)."""
        e = self.engine
        out = []
        seen: set[str] = set()
        for refl in self.reflections(index):
            if refl.get("kind") != "contradiction":
                continue
            for mid in str(refl.get("subject", "")).split("|"):
                if not mid or mid in seen or len(out) >= max_nodes:
                    continue
                seen.add(mid)
                try:
                    b = e.belief_state(index, mid)
                except KeyError:
                    continue
                state = b.get("state") if isinstance(b, dict) else \
                    getattr(b, "state", None)
                if state not in ("contested", "volatile"):
                    continue
                verdict = self._adjudicate(index, mid, b)
                out.append(verdict)
                self._store_reflection(index, {
                    "kind": "belief_resolution", "subject": mid,
                    "links": [mid],
                    "content": verdict["recommendation"]})
        return out

    def _adjudicate(self, index: str, mid: str, belief) -> dict:
        e = self.engine
        h = e._handle(index)
        row = h.index.ids.get(mid)
        content = str((h.meta.get(row) or {}).get("content", "")) \
            if row is not None else ""
        attackers = [r["source"] for r in
                     e.get_incoming_edges(index, mid)
                     if r["relation"] in ("contradicts", "invalidates")]
        rec = None
        if self.llm is not None and attackers:
            texts = []
            for a in attackers[:3]:
                arow = h.index.ids.get(a)
                if arow is not None:
                    texts.append(str((h.meta.get(arow) or {})
                                     .get("content", ""))[:300])
            try:
                resp = self.llm.chat(
                    "A belief is contested. Decide which statement is more "
                    'likely current and reply JSON {"keep": "belief"|'
                    '"challenger", "reason": "..."}.',
                    f"belief: {content[:300]}\nchallengers: {texts}")
                parsed = clean_llm_json(resp)
                if isinstance(parsed, dict) and parsed.get("keep"):
                    rec = (f"LLM adjudication: keep {parsed['keep']} — "
                           f"{str(parsed.get('reason', ''))[:200]}")
            except Exception:
                pass
        if rec is None:
            conf = belief.get("confidence") if isinstance(belief, dict) \
                else getattr(belief, "confidence", 0.0)
            rec = (f"Belief '{mid}' is {belief.get('state') if isinstance(belief, dict) else getattr(belief, 'state', '?')} "
                   f"(confidence {float(conf or 0):.2f}) with "
                   f"{len(attackers)} challenger(s) — review and either "
                   "evolve it (VEvolve) or unlink stale challengers.")
        return {"id": mid, "recommendation": rec,
                "challengers": attackers[:5]}

    # ------------------------------------------------ session summarization
    # (gardener.go:1563: roll a finished session into one summary memory)

    def summarize_session(self, index: str, session_id: str,
                          store: bool = True) -> Optional[dict]:
        e = self.engine
        h = e._handle(index)
        members = []
        for row, meta in h.meta.direct.items():
            if meta.get("session_id") != session_id:
                continue
            if meta.get("type") in (REFLECTION_TYPE, "session_summary"):
                continue
            ext = h.index.ids.row_to_ext[row] \
                if row < len(h.index.ids.row_to_ext) else None
            if ext:
                members.append((float(meta.get(fusion.CREATED_KEY) or 0),
                                ext, str(meta.get("content", ""))))
        if not members:
            return None
        members.sort()
        contents = [c for _, _, c in members if c]
        if not contents:
            contents = [f"({len(members)} memories without text content)"]
        summary = None
        if self.llm is not None:
            try:
                summary = self.llm.chat(
                    "Summarize this agent session in 2-3 sentences, keeping "
                    "decisions and open questions.",
                    "\n".join(f"- {c[:200]}" for c in contents[:20]))
                summary = (summary or "").strip()[:800] or None
            except Exception:
                summary = None
        if not summary:
            # deterministic: first + last + top recurring entities
            from collections import Counter
            from ..text.analyzer import analyze
            counter = Counter()
            for c in contents:
                counter.update(set(analyze(c)))
            top = ", ".join(w for w, _ in counter.most_common(5))
            summary = (f"Session covered {len(members)} memories, from "
                       f"\"{contents[0][:80]}\" to \"{contents[-1][:80]}\". "
                       f"Recurring topics: {top}.")
        out = {"session_id": session_id, "summary": summary,
               "member_count": len(members),
               "members": [m for _, m, _ in members][:20]}
        if store:
            sid = f"sess_sum_{session_id[:12]}"
            if sid not in h.index.ids:
                vec = self._embed_for_index(h, summary)
                if vec is None:
                    vecs = [h.index.get_vector(m) for _, m, _ in members[:8]]
                    vecs = [v for v in vecs if v is not None]
                    vec = np.mean(vecs, axis=0) if vecs else None
                if vec is not None:
                    e.add(index, sid, np.asarray(vec, np.float32),
                          {"content": summary, "type": "session_summary",
                           "session_id": session_id, "_pinned": True,
                           fusion.LAYER_KEY: "semantic"})
                    for _, m, _ in members[:20]:
                        e.link(index, sid, "summarizes", m,
                               inverse="summarized_by")
            out["summary_id"] = sid
        return out

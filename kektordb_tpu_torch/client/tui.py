"""Terminal dashboard (curses).

Reference: internal/tui — Bubble Tea v2 dashboard with 5 tabs
(dashboard / graph / search / timeline / settings) fed by the HTTP API and
the SSE event stream. This is the Python/curses equivalent, launched with
`python -m kektordb_tpu_torch.client.tui [base_url]`.

Global keys: 1-5 switch tabs, r refresh, / focus search input, q quit.
Per-tab keys render in the footer: the graph tab navigates nodes (j/k,
Enter expands a node into its edges + belief state, b backs out), the
search tab selects an index ([ / ]) and jumps from a hit into the graph
detail (Enter), the timeline filters by event family (f) and pauses (p),
and the settings tab edits ef_search (+ / -) and cycles serve_mode (m)
live through the config API.
"""

from __future__ import annotations

import curses
import json
import queue
import threading
import time
from typing import Optional

from .client import KektorDBClient, KektorDBError

TABS = ["Dashboard", "Graph", "Search", "Timeline", "Settings"]
SPARK = " ▁▂▃▄▅▆▇█"
EVENT_FILTERS = ["all", "vector", "edge", "memory"]
SERVE_MODES = ["auto", "scan", "beam"]


class EventTail:
    """SSE tail of /events/stream feeding the Timeline tab."""

    def __init__(self, base_url: str):
        self.base_url = base_url
        self.events: queue.Queue = queue.Queue(maxsize=500)
        self.items: list[dict] = []
        t = threading.Thread(target=self._run, daemon=True)
        t.start()

    def _run(self) -> None:
        import requests
        while True:
            try:
                with requests.get(self.base_url + "/events/stream",
                                  stream=True, timeout=3600) as r:
                    for line in r.iter_lines():
                        if line and line.startswith(b"data: "):
                            try:
                                ev = json.loads(line[6:])
                                ev.setdefault("ts", time.time())
                                self.events.put_nowait(ev)
                            except (ValueError, queue.Full):
                                pass
            except Exception:
                time.sleep(2.0)

    def drain(self) -> list[dict]:
        while True:
            try:
                self.items.append(self.events.get_nowait())
            except queue.Empty:
                break
        self.items = self.items[-500:]
        return self.items


def _sparkline(counts: list[int], width: int) -> str:
    """Event-rate sparkline (the Bubble Tea dashboard's activity strip)."""
    counts = counts[-width:]
    peak = max(counts) if counts else 0
    if peak == 0:
        return " " * len(counts)
    return "".join(SPARK[min(int(c / peak * (len(SPARK) - 1)), 8)]
                   for c in counts)


class TUI:
    def __init__(self, base_url: str = "http://localhost:9091",
                 token: Optional[str] = None):
        self.client = KektorDBClient(base_url, token)
        self.tail = EventTail(base_url)
        self.tab = 0
        self.status = "connecting…"
        self.stats: dict = {}
        self.indexes: list[str] = []
        self.index_sel = 0          # shared index selector ([ / ])
        # search tab
        self.search_input = ""
        self.search_results: list[dict] = []
        self.search_cursor = 0
        # graph tab
        self.graph_nodes: list[str] = []
        self.graph_cursor = 0
        self.graph_detail: Optional[dict] = None   # expanded node view
        # timeline tab
        self.ev_filter = 0
        self.ev_paused = False
        self.ev_frozen: list[dict] = []
        # settings tab
        self.cfg_msg = ""

    # ------------------------------------------------------------ data

    @property
    def index(self) -> str:
        return self.indexes[self.index_sel] if self.indexes else ""

    def refresh(self) -> None:
        try:
            self.stats = self.client.stats()
            self.indexes = sorted((self.stats.get("indexes") or {}).keys())
            self.index_sel = min(self.index_sel,
                                 max(len(self.indexes) - 1, 0))
            self.status = "connected"
        except Exception as e:
            self.status = f"error: {e}"

    def cycle_index(self, step: int) -> None:
        if self.indexes:
            self.index_sel = (self.index_sel + step) % len(self.indexes)
            self.graph_nodes = []
            self.graph_detail = None
            self.graph_cursor = 0

    def run_search(self) -> None:
        try:
            if not self.indexes:
                self.refresh()
            if not self.indexes:
                self.search_results = []
                return
            from ..services.embeddings import HashingEmbedder
            qv = HashingEmbedder().embed(self.search_input).tolist()
            out = self.client.vsearch(self.index, qv, k=10,
                                      text_query=self.search_input,
                                      hydrate=True)
            self.search_results = out["results"]
            self.search_cursor = 0
        except KektorDBError as e:
            self.search_results = [{"id": f"error: {e}", "score": 0}]

    def load_graph_nodes(self) -> None:
        try:
            out = self.client.search_nodes(self.index, limit=200)
            self.graph_nodes = [n["id"] for n in out.get("nodes", [])]
        except Exception as e:
            self.graph_nodes = [f"error: {e}"]
        self.graph_cursor = 0

    def expand_node(self, node_id: str) -> None:
        """Node detail: out/in edges + belief state (the reference's graph
        inspector drill-down)."""
        detail: dict = {"id": node_id, "out": [], "in": [], "belief": None}
        try:
            detail["out"] = self.client.get_links(
                self.index, node_id).get("edges", [])
        except Exception:
            pass
        try:
            detail["in"] = self.client.get_incoming(
                self.index, node_id).get("edges", [])
        except Exception:
            pass
        try:
            detail["belief"] = self.client.belief_state(
                self.index, node_id)
        except Exception:
            pass
        self.graph_detail = detail

    # ---------------------------------------------------------- render

    def draw(self, scr) -> None:
        scr.erase()
        h, w = scr.getmaxyx()
        try:
            header = "  ".join(
                f"[{i + 1}:{name}]" if i == self.tab else f" {i + 1}:{name} "
                for i, name in enumerate(TABS))
            scr.addnstr(0, 0, f"KektorDB-TPU  {header}", w - 1,
                        curses.A_REVERSE)
            hints = {
                0: "r:refresh /:search q:quit",
                1: "[/]:index j/k:move Enter:expand b:back r:reload q:quit",
                2: "[/]:index /:type j/k:move Enter:inspect-in-graph q:quit",
                3: "f:filter p:pause q:quit",
                4: "+/-:ef_search m:serve_mode q:quit",
            }[self.tab]
            scr.addnstr(h - 1, 0, f" {self.status} | {hints}", w - 1,
                        curses.A_DIM)
            body = scr.derwin(h - 2, w, 1, 0)
            [self._dashboard, self._graph, self._search, self._timeline,
             self._settings][self.tab](body)
        except curses.error:
            # terminal shrunk below the tab's layout (tabs write some
            # fixed rows): render the clipped frame instead of letting
            # addnstr's out-of-bounds error kill the loop
            pass
        scr.refresh()

    def _dashboard(self, win) -> None:
        h, w = win.getmaxyx()
        rows = [("index", "vectors", "deleted", "metric", "prec",
                 "serve", "text docs", "mask h/m")]
        for name, info in (self.stats.get("indexes") or {}).items():
            text = info.get("text") or {}
            docs = sum(int(f.get("docs", 0)) for f in text.values())
            mc = info.get("mask_cache") or {}
            rows.append((name, str(info["size"]), str(info["deleted"]),
                         info["metric"], info["precision"],
                         str(info.get("serve_mode", "")), str(docs),
                         f"{mc.get('hits', 0)}/{mc.get('misses', 0)}"))
        for y, row in enumerate(rows[: h - 6]):
            attr = curses.A_BOLD if y == 0 else 0
            win.addnstr(y + 1, 2, "  ".join(s.ljust(10) for s in row),
                        w - 3, attr)
        y = len(rows) + 2
        if y < h - 3:
            win.addnstr(y, 2,
                        f"kv keys: {self.stats.get('kv_keys', 0)}   "
                        f"graph nodes: {self.stats.get('graph_nodes', 0)}   "
                        f"dirty ops: {self.stats.get('dirty_ops', 0)}   "
                        f"events dropped: "
                        f"{self.stats.get('events_dropped', 0)}",
                        w - 3)
        if y + 2 < h - 1:
            # activity strip: events per 2s bucket from the SSE tail
            items = self.tail.items
            now = time.time()
            buckets = [0] * 30
            for ev in items:
                age = now - ev.get("ts", now)
                b = int(age // 2)
                if 0 <= b < 30:
                    buckets[29 - b] += 1
            win.addnstr(y + 2, 2,
                        f"activity (60s): {_sparkline(buckets, w - 24)}",
                        w - 3)

    def _graph(self, win) -> None:
        h, w = win.getmaxyx()
        if self.graph_detail is not None:
            d = self.graph_detail
            win.addnstr(1, 2, f"node {d['id']}  (b: back)", w - 3,
                        curses.A_BOLD)
            y = 3
            bel = d.get("belief")
            if isinstance(bel, dict):
                win.addnstr(
                    y, 2,
                    f"belief: {bel.get('state', '?')}  "
                    f"score={bel.get('confidence', bel.get('score', ''))}",
                    w - 3)
                y += 2
            win.addnstr(y, 2, f"out edges ({len(d['out'])}):", w - 3,
                        curses.A_UNDERLINE)
            y += 1
            for e in d["out"][: max((h - y - 4) // 2, 1)]:
                win.addnstr(y, 4, f"-[{e.get('relation', e.get('type', ''))}"
                            f" w={e.get('weight', 1.0)}]-> "
                            f"{e.get('target', '')}", w - 5)
                y += 1
            if y < h - 2:
                win.addnstr(y + 1, 2, f"in edges ({len(d['in'])}):", w - 3,
                            curses.A_UNDERLINE)
                y += 2
                for e in d["in"][: h - y - 1]:
                    win.addnstr(y, 4,
                                f"<-[{e.get('relation', e.get('type', ''))}]"
                                f"- {e.get('source', '')}", w - 5)
                    y += 1
            return
        win.addnstr(1, 2, f"Graph explorer — index: {self.index or '—'}  "
                    f"({len(self.graph_nodes)} nodes loaded)", w - 3,
                    curses.A_BOLD)
        if not self.graph_nodes:
            win.addnstr(3, 2, "press r to load nodes, [ ] to switch index",
                        w - 3, curses.A_DIM)
            return
        top = max(0, self.graph_cursor - (h - 5))
        for y, nid in enumerate(self.graph_nodes[top: top + h - 4]):
            attr = curses.A_REVERSE if top + y == self.graph_cursor else 0
            win.addnstr(y + 3, 2, f"{nid}", w - 3, attr)

    def _search(self, win) -> None:
        h, w = win.getmaxyx()
        win.addnstr(1, 2, f"index: {self.index or '—'}   "
                    f"query> {self.search_input}", w - 3, curses.A_BOLD)
        for y, hit in enumerate(self.search_results[: h - 5]):
            meta = hit.get("metadata") or {}
            line = f"{hit['id']}  score={hit.get('score', 0):.3f}  " \
                   f"{str(meta.get('content', ''))[:60]}"
            attr = curses.A_REVERSE if y == self.search_cursor else 0
            win.addnstr(y + 3, 2, line, w - 3, attr)

    def _timeline(self, win) -> None:
        h, w = win.getmaxyx()
        flt = EVENT_FILTERS[self.ev_filter]
        state = "PAUSED" if self.ev_paused else "live"
        win.addnstr(1, 2, f"Events (/events/stream)  filter: {flt}  "
                    f"[{state}]", w - 3, curses.A_BOLD)
        items = self.ev_frozen if self.ev_paused else self.tail.drain()
        if flt != "all":
            items = [e for e in items
                     if str(e.get("type", "")).startswith(flt)]
        counts: dict[str, int] = {}
        for ev in items:
            t = str(ev.get("type", "?"))
            counts[t] = counts.get(t, 0) + 1
        summary = "  ".join(f"{t}:{n}" for t, n in
                            sorted(counts.items())[:6])
        win.addnstr(2, 2, summary, w - 3, curses.A_DIM)
        for y, ev in enumerate(reversed(items[-(h - 5):])):
            ts = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
            win.addnstr(y + 4, 2,
                        f"{ts}  {ev.get('type', ''):20} "
                        f"{ev.get('index', '')}/{ev.get('id', '')}", w - 3)

    def _settings(self, win) -> None:
        h, w = win.getmaxyx()
        win.addnstr(1, 2, "Connection", w - 3, curses.A_BOLD)
        win.addnstr(3, 2, f"base url: {self.client.base_url}", w - 3)
        win.addnstr(4, 2, f"status:   {self.status}", w - 3)
        info = (self.stats.get("indexes") or {}).get(self.index) or {}
        cfg = info.get("config") or {}
        win.addnstr(6, 2, f"Index config — {self.index or '—'} "
                    "([ ] to switch)", w - 3, curses.A_BOLD)
        win.addnstr(8, 2,
                    f"ef_search:  {cfg.get('ef_search', '?')}   (+ / -)",
                    w - 3)
        win.addnstr(9, 2,
                    f"serve_mode: {cfg.get('serve_mode', '?')}   (m cycles)",
                    w - 3)
        mem = info.get("memory") or {}
        win.addnstr(10, 2,
                    f"memory:     enabled={mem.get('enabled', False)} "
                    f"half_life={mem.get('decay_half_life', 0):.0f}s "
                    f"model={mem.get('decay_model', '')}", w - 3)
        if self.cfg_msg and h > 12:
            win.addnstr(12, 2, self.cfg_msg, w - 3, curses.A_DIM)

    # --------------------------------------------------------- actions

    def _adjust_ef(self, delta: int) -> None:
        info = (self.stats.get("indexes") or {}).get(self.index) or {}
        ef = int((info.get("config") or {}).get("ef_search", 100))
        new = max(1, ef + delta)
        try:
            self.client.configure_index(self.index, {"ef_search": new})
            self.cfg_msg = f"ef_search → {new}"
            self.refresh()
        except Exception as e:
            self.cfg_msg = f"config error: {e}"

    def _cycle_serve_mode(self) -> None:
        info = (self.stats.get("indexes") or {}).get(self.index) or {}
        cur = (info.get("config") or {}).get("serve_mode", "auto")
        new = SERVE_MODES[(SERVE_MODES.index(cur) + 1) % len(SERVE_MODES)] \
            if cur in SERVE_MODES else "auto"
        try:
            self.client.configure_index(self.index, {"serve_mode": new})
            self.cfg_msg = f"serve_mode → {new}"
            self.refresh()
        except Exception as e:
            self.cfg_msg = f"config error: {e}"

    # ------------------------------------------------------------- loop

    def _key_tab(self, ch) -> None:
        """Per-tab key handling (after the global keys)."""
        if ch in (ord("["), ord("]")) and self.tab in (1, 2, 4):
            self.cycle_index(1 if ch == ord("]") else -1)
        if self.tab == 1:                               # graph
            if ch == ord("r") or (not self.graph_nodes
                                  and ch in (ord("j"), ord("k"))):
                self.load_graph_nodes()
            elif ch == ord("j") and self.graph_nodes:
                self.graph_cursor = min(self.graph_cursor + 1,
                                        len(self.graph_nodes) - 1)
            elif ch == ord("k") and self.graph_nodes:
                self.graph_cursor = max(self.graph_cursor - 1, 0)
            elif ch in (curses.KEY_ENTER, 10, 13) and self.graph_nodes:
                self.expand_node(self.graph_nodes[self.graph_cursor])
            elif ch == ord("b"):
                self.graph_detail = None
        elif self.tab == 2:                             # search
            if ch == ord("j") and self.search_results:
                self.search_cursor = min(self.search_cursor + 1,
                                         len(self.search_results) - 1)
            elif ch == ord("k") and self.search_results:
                self.search_cursor = max(self.search_cursor - 1, 0)
            elif ch in (curses.KEY_ENTER, 10, 13) and self.search_results:
                hit = self.search_results[self.search_cursor]
                self.tab = 1
                self.expand_node(str(hit.get("id", "")))
        elif self.tab == 3:                             # timeline
            if ch == ord("f"):
                self.ev_filter = (self.ev_filter + 1) % len(EVENT_FILTERS)
            elif ch == ord("p"):
                self.ev_paused = not self.ev_paused
                if self.ev_paused:
                    self.ev_frozen = list(self.tail.drain())
        elif self.tab == 4:                             # settings
            if ch in (ord("+"), ord("=")):
                self._adjust_ef(+20)
            elif ch == ord("-"):
                self._adjust_ef(-20)
            elif ch == ord("m"):
                self._cycle_serve_mode()

    def loop(self, scr) -> None:
        curses.curs_set(0)
        scr.timeout(500)
        self.refresh()
        last_refresh = time.time()
        typing = False
        while True:
            if time.time() - last_refresh > 5:
                self.refresh()
                last_refresh = time.time()
            self.draw(scr)
            try:
                ch = scr.getch()
            except KeyboardInterrupt:
                return
            if ch == -1:
                continue
            if typing:
                if ch in (curses.KEY_ENTER, 10, 13):
                    typing = False
                    self.run_search()
                elif ch in (curses.KEY_BACKSPACE, 127, 8):
                    self.search_input = self.search_input[:-1]
                elif 32 <= ch < 127:
                    self.search_input += chr(ch)
                continue
            if ch in (ord("q"), 27):
                return
            if ch == ord("r") and self.tab != 1:
                self.refresh()
            elif ch == ord("/"):
                self.tab = 2
                self.search_input = ""
                typing = True
            elif ord("1") <= ch <= ord("5"):
                self.tab = ch - ord("1")
            else:
                self._key_tab(ch)


def main(argv=None) -> int:
    import sys
    args = argv if argv is not None else sys.argv[1:]
    base = args[0] if args else "http://localhost:9091"
    tui = TUI(base)
    curses.wrapper(tui.loop)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

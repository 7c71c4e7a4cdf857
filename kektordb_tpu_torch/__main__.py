"""CLI — `python -m kektordb_tpu_torch`.

Reference: cmd/kektordb/main.go:83-136 — flags (port, data dir, token, log
level) and mode fork: HTTP server (default) | MCP stdio | setup.
Env vars mirror the reference: KEKTOR_PORT, KEKTOR_DATA_DIR, KEKTOR_TOKEN
(DOCUMENTATION.md:225-242). `--device` (default "cuda") is the Engine's
device; `--device cpu` runs on the CPU. `tui` is the terminal dashboard
(client/tui.py) against a running server. The distributed flags join a
torch.distributed process group (distboot.init_distributed) before the
Engine starts; every process then serves its own replica, fed the same
write stream.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kektordb-tpu-torch",
        description="vector database / temporal knowledge graph on PyTorch "
                    "and CUDA")
    p.add_argument("mode", nargs="?", default="serve",
                   choices=["serve", "mcp", "setup", "tui"],
                   help="serve: HTTP REST (default); mcp: JSON-RPC stdio; "
                        "setup: write agent MCP config; tui: terminal "
                        "dashboard against a running server")
    p.add_argument("--url", default=os.environ.get(
        "KEKTOR_URL", "http://localhost:9091"),
        help="tui mode: server base URL")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("KEKTOR_PORT", 9091)))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--data-dir",
                   default=os.environ.get("KEKTOR_DATA_DIR") or None)
    p.add_argument("--token", default=os.environ.get("KEKTOR_TOKEN") or None)
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--config", default=os.environ.get("KEKTOR_CONFIG"),
                   help="YAML config (embedder/llm/gardener/vectorizers/proxy)")
    p.add_argument("--agent", default="claude-code",
                   help="setup mode: target agent")
    p.add_argument("--device", default="cuda",
                   help="the Engine's device: cuda (default) or cpu")
    # multi-process: join a torch.distributed group before the Engine
    # starts (parallel/distributed.py: the replica axis over processes)
    p.add_argument("--coordinator",
                   default=os.environ.get("KEKTOR_COORDINATOR") or None,
                   help="process-group address host:port (rank 0 listens "
                        "there)")
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("KEKTOR_PROCESS_ID", -1)))
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("KEKTOR_NUM_PROCESSES", 0)))
    args = p.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    if args.coordinator or args.num_processes > 0 or args.process_id >= 0:
        from .distboot import init_distributed
        try:
            init_distributed(
                args.coordinator, num_processes=args.num_processes,
                process_id=args.process_id, device=args.device)
        except ValueError as e:
            raise SystemExit(f"distributed flags: {e}")
        import torch.distributed as tdist
        got = tdist.get_world_size()
        if got != args.num_processes:
            # an explicitly requested group size must form: serving a
            # partial replica set would split the brain
            raise SystemExit(
                f"distributed init yielded {got} processes, "
                f"--num-processes asked for {args.num_processes}")

    if args.mode == "tui":
        from .client.tui import main as tui_main
        return tui_main([args.url])

    if args.mode == "setup":
        from .server.setup import write_agent_config
        path = write_agent_config(args.agent)
        print(f"wrote MCP config for {args.agent}: {path}")
        return 0

    from .engine import Engine, EngineConfig
    from .server.config import build_services, load_config
    engine = Engine(EngineConfig(device=args.device,
                                 data_dir=args.data_dir)).open()
    cfg = load_config(args.config)
    svcs = build_services(engine, cfg)
    from .services.background import ServiceLoop
    loop = ServiceLoop(engine, gardener=svcs["gardener"],
                       vectorizers=svcs["vectorizers"],
                       compiler=svcs["compiler"],
                       gateway=svcs["gateway"]).start()
    try:
        if args.mode == "mcp":
            from .server.mcp import serve_stdio
            serve_stdio(engine, embedder=svcs["embedder"],
                        compiler=svcs["compiler"],
                        gardener=svcs["gardener"])
        else:
            from .server.http import run_server
            run_server(engine, host=args.host, port=args.port,
                       token=args.token, embedder=svcs["embedder"],
                       gardener=svcs["gardener"],
                       compiler=svcs["compiler"], rag=svcs["rag"],
                       vectorizers=svcs["vectorizers"])
    finally:
        loop.stop()
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

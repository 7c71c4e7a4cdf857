"""`setup <agent>` — write MCP client config for coding agents.

Reference: internal/setup/setup.go:45-65 — per-agent config writers for
claude-code, cursor, gemini-cli, codex, opencode."""

from __future__ import annotations

import json
import os
import sys

SERVER_ENTRY = {
    "command": sys.executable,
    "args": ["-m", "kektordb_tpu_torch", "mcp"],
}

AGENTS = {
    "claude-code": ("~/.claude.json", "mcpServers"),
    "cursor": ("~/.cursor/mcp.json", "mcpServers"),
    "gemini-cli": ("~/.gemini/settings.json", "mcpServers"),
    "codex": ("~/.codex/config.json", "mcp_servers"),
    "opencode": ("~/.config/opencode/config.json", "mcp"),
}


def write_agent_config(agent: str, name: str = "kektordb") -> str:
    if agent not in AGENTS:
        raise ValueError(
            f"unknown agent {agent!r}; known: {', '.join(sorted(AGENTS))}")
    path, key = AGENTS[agent]
    path = os.path.expanduser(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cfg = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                cfg = json.load(f)
        except ValueError:
            cfg = {}
    cfg.setdefault(key, {})[name] = dict(SERVER_ENTRY)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path

"""The port's services (kektordb_tpu_torch/services, server/mcp.py,
text/splitter.py, text/compressor.py), copies of the JAX package's.

The reference's own cases (tests/test_services.py) run against the
copies (test_torch_port_reference.reference_cases: every `kektordb_tpu`
module becomes its `kektordb_tpu_torch` copy and every Engine runs on
DEVICE), collected here under their own names. Then the port's own
rules: MCP lists the reference's 61 tools, and each one dispatches
cleanly on an engine holding a vector, a link and a KV key; the local
MiniLM embedder is ported (it needs weights on disk, and raises its
loader's error without them), while "auto" keeps the reference's
fallback to hashing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
from test_torch_port_reference import DEVICE, reference_cases

from kektordb_tpu.engine import Engine as JEngine
from kektordb_tpu.engine import EngineConfig as JEngineConfig
from kektordb_tpu.server.mcp import MCPService as JMCPService
from kektordb_tpu.server.mcp import handle_rpc as jhandle_rpc
from kektordb_tpu_torch.engine import Engine, EngineConfig
from kektordb_tpu_torch.server.mcp import MCPService, handle_rpc
from kektordb_tpu_torch.services import embeddings

_REF = Path(__file__).resolve().parent / "test_services.py"


exec(compile(reference_cases("test_services.py"), str(_REF), "exec"))


def test_reference_cases_were_ported():
    src = reference_cases("test_services.py")
    assert "from kektordb_tpu." not in src
    assert src.count(f'EngineConfig(start_background=False, '
                     f'device="{DEVICE}")') == \
        _REF.read_text().count("EngineConfig(start_background=False)") >= 3


def _engines():
    """The same content in an engine of each package: three 384-d memories
    (the hashing embedder's width) in a flat index, a link and a KV key."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 384)).astype(np.float32)
    out = []
    for e in (Engine(EngineConfig(device="cpu", start_background=False)),
              JEngine(JEngineConfig(start_background=False))):
        e.open()
        e.create_index("mem", metric="cosine", kind="flat")
        e.add_batch("mem", ["a", "b", "c"], X,
                    [{"content": "alpha note", "type": "memory"},
                     {"content": "beta note", "type": "memory"},
                     {"content": "gamma", "type": "entity"}])
        e.link("mem", "a", "rel", "b")
        e.kv_set("k1", "v1")
        out.append(e)
    return out


# one value per argument name the tools declare
ARGS = {"index": "mem", "content": "alpha note again", "id": "a",
        "ids": ["a"], "key": "k1", "value": "v2", "query": "alpha",
        "question": "what is alpha?", "k": 3, "limit": 5, "offset": 0,
        "source": "a", "target": "b", "relation": "rel", "weight": 0.5,
        "old_id": "b", "new_content": "beta, revised", "root_id": "a",
        "depth": 2, "session_id": "s1", "topic": "alpha",
        "entity_id": "c", "entity_type": "entity", "user_id": "u1",
        "filter": "type = memory", "metadata": {"type": "memory"}}


def test_mcp_lists_the_reference_tools():
    e = Engine(EngineConfig(device="cpu", start_background=False)).open()
    je = JEngine(JEngineConfig(start_background=False)).open()
    names = [t["name"] for t in MCPService(e).list_tools()]
    want = [t["name"] for t in JMCPService(je).list_tools()]
    assert len(names) == 61 and names == want
    e.close()
    je.close()


def _outcome(resp):
    if "error" in resp:
        return "error", resp["error"]["code"]
    json.loads(resp["result"]["content"][0]["text"])
    return "ok", None


def test_every_mcp_tool_dispatches():
    """Each of the 61 tools, called over JSON-RPC in the same order with
    the same arguments on both packages (each tool gets the ARGS its
    schema declares), ends as the reference's does: a result, or the same
    JSON-RPC error code. Most of them succeed."""
    e, je = _engines()
    svc, jsvc = MCPService(e), JMCPService(je)
    ok = 0
    for i, t in enumerate(svc.list_tools()):
        args = {p: ARGS[p] for p in t["inputSchema"].get("properties", {})
                if p in ARGS}
        req = {"jsonrpc": "2.0", "id": i, "method": "tools/call",
               "params": {"name": t["name"], "arguments": args}}
        got = _outcome(handle_rpc(svc, req))
        want = _outcome(jhandle_rpc(jsvc, req))
        assert got == want, (t["name"], got, want)
        ok += got[0] == "ok"
    assert ok >= 44, ok             # 44 of the 61 answer on this content
    e.close()
    je.close()


def test_mcp_vector_tool_call():
    e, je = _engines()
    je.close()
    svc = MCPService(e)
    resp = handle_rpc(svc, {
        "jsonrpc": "2.0", "id": 1, "method": "tools/call",
        "params": {"name": "list_vectors",
                   "arguments": {"index": "mem", "limit": 10}}})
    out = json.loads(resp["result"]["content"][0]["text"])
    assert out["ids"] == ["a", "b", "c"] and out["total"] == 3
    e.close()


def test_local_embedder_not_ported(tmp_path, monkeypatch):
    """No longer refused: without weights on disk the local embedder
    raises the loader's own error, and with a weights directory it runs
    (on the CPU when asked)."""
    monkeypatch.setenv("KEKTOR_MODEL_DIR", str(tmp_path / "models"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.delenv("KEKTOR_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(Exception) as e:
        embeddings.select_embedder("local", device="cpu")
    assert not isinstance(e.value, NotImplementedError)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embeddings.MiniLMEmbedder()     # default "cuda", no card here
    from safetensors import numpy as st_np
    from tokenizers import Tokenizer, models, pre_tokenizers

    from kektordb_tpu_torch.services.minilm import MiniLMEncoder
    d = tmp_path / "w"
    d.mkdir()
    st_np.save_file(MiniLMEncoder.random_params(
        vocab_size=16, dim=32, n_layers=1, n_heads=4, intermediate=64,
        max_pos=32), str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(
        {"num_hidden_layers": 1, "num_attention_heads": 4,
         "hidden_size": 32}))
    tk = Tokenizer(models.WordLevel({"[UNK]": 0, "hi": 1},
                                    unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.save(str(d / "tokenizer.json"))
    emb = embeddings.select_embedder("local", weights_dir=str(d),
                                     device="cpu")
    v = emb.embed("hi there")
    assert emb.name == "local" and v.shape == (32,)
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-5)


def test_auto_embedder_falls_back_to_hashing(monkeypatch):
    monkeypatch.delenv("KEKTOR_EMBEDDER_URL", raising=False)
    e = embeddings.select_embedder("auto")
    assert isinstance(e, embeddings.HashingEmbedder)
    assert e.embed_batch(["x", "y"]).shape == (2, e.dim)

"""BERT-family sentence encoder in PyTorch: the port of
kektordb_tpu/services/minilm.py, the `local` embedder.

Any BERT-architecture sentence-transformers checkpoint (all-MiniLM-*,
bge-small/base, gte, e5, paraphrase-*): the layer count, head count and
width come from config.json, the pooling mode (mean or CLS) from the
sentence-transformers 1_Pooling/config.json when present. The forward
(`bert_forward`) follows the reference's `_bert_forward` op for op in
float32: embeddings and LayerNorm (eps 1e-12), per layer Q / K / V as
y @ W.T + b, scores over sqrt(head dim) plus the mask bias
(1 - mask) * -1e9, softmax, the output dense and residual LayerNorm, the
exact (erf) GELU feed-forward, then mean pooling over the mask or the
[CLS] token, and L2 normalisation clamped at 1e-12. The JAX package runs
it outside any Pallas kernel; so does the port, as plain torch products.
TF32 stays off (device.py), so a card's output can be held to the CPU's.

Weights: a directory with {model.safetensors, config.json,
tokenizer.json} (services/download.py) loaded with `safetensors` and
`tokenizers`, or a locally cached Hugging Face checkpoint through
`transformers`. Each of those packages is imported only on its own load
path; `from_params` takes the reference's parameter dict (numpy arrays
keyed by Hugging Face names) and needs none of them.
"""

from __future__ import annotations

import importlib
import json
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import device as devlib


def _need(module: str, what: str):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"the local MiniLM encoder needs the {module!r} "
                          f"package to {what}") from e


class MiniLMEncoder(nn.Module):
    """The encoder as a module: `forward(ids [B, T], mask [B, T])` ->
    [B, dim] pooled, L2-normalised embeddings, on `device` ("cuda" by
    default; "cpu" when asked). The weights are a dict of tensors keyed by
    their Hugging Face names (`params`)."""

    MAX_LEN = 256

    def __init__(self,
                 model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
                 weights_dir: str | None = None,
                 pooling: str | None = None, *, device="cuda"):
        """weights_dir: a directory with {model.safetensors, config.json,
        tokenizer.json}. Without it, a locally cached Hugging Face
        checkpoint (no network). pooling: "mean" or "cls"; None detects it
        from 1_Pooling/config.json and defaults to "mean"."""
        super().__init__()
        self.model_name = model_name
        self.weights_dir = weights_dir
        self.pooling = pooling
        self.dev = devlib.resolve(device)
        self._custom_tokenize = None
        self._load()

    def _load(self) -> None:
        if self.weights_dir:
            self._load_from_dir(self.weights_dir)
        else:
            self._load_from_hf_cache()
        if self.pooling is None:
            self.pooling = "mean"
        if self.pooling not in ("mean", "cls"):
            raise ValueError(f"unknown pooling {self.pooling!r}")

    def _set_params(self, params: dict) -> None:
        self.params = {k: devlib.from_numpy(v, self.dev)
                       for k, v in params.items()}

    def _load_from_dir(self, d: str) -> None:
        st_np = _need("safetensors.numpy", "read model.safetensors")
        tokenizers = _need("tokenizers", "read tokenizer.json")
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        if self.pooling is None:
            # sentence-transformers checkpoints record the pooling head in
            # 1_Pooling/config.json (bge = CLS, MiniLM / e5 / gte = mean)
            pool_cfg = os.path.join(d, "1_Pooling", "config.json")
            if os.path.exists(pool_cfg):
                with open(pool_cfg) as f:
                    pc = json.load(f)
                if pc.get("pooling_mode_cls_token"):
                    self.pooling = "cls"
                elif pc.get("pooling_mode_mean_tokens"):
                    self.pooling = "mean"
        self._set_params(st_np.load_file(
            os.path.join(d, "model.safetensors")))
        tk = tokenizers.Tokenizer.from_file(os.path.join(d, "tokenizer.json"))
        tk.enable_truncation(self.MAX_LEN)
        tk.enable_padding(length=None)   # pad to the longest in the batch
        self._hf_tokenizer = None
        self._tk = tk
        self.n_layers = cfg["num_hidden_layers"]
        self.n_heads = cfg["num_attention_heads"]
        self.dim = cfg["hidden_size"]

    def _load_from_hf_cache(self) -> None:
        tr = _need("transformers", "load a cached Hugging Face checkpoint")
        self._hf_tokenizer = tr.AutoTokenizer.from_pretrained(
            self.model_name, local_files_only=True)
        self._tk = None
        cfg = tr.AutoConfig.from_pretrained(self.model_name,
                                            local_files_only=True)
        model = tr.AutoModel.from_pretrained(self.model_name,
                                             local_files_only=True)
        self.params = {k: v.detach().to(self.dev)
                       for k, v in model.state_dict().items()}
        del model
        self.n_layers = cfg.num_hidden_layers
        self.n_heads = cfg.num_attention_heads
        self.dim = cfg.hidden_size

    @classmethod
    def from_params(cls, params: dict, tokenize_fn, *, n_layers: int,
                    n_heads: int, dim: int, pooling: str = "mean",
                    device="cuda") -> "MiniLMEncoder":
        """From explicit parameters (numpy arrays or tensors keyed by
        Hugging Face names: the dict the JAX encoder takes) and a
        tokenizer callable: tokenize_fn(texts) -> (input_ids [B, T] int,
        attention_mask [B, T] float)."""
        if pooling not in ("mean", "cls"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.model_name = "custom"
        self.weights_dir = None
        self.pooling = pooling
        self.dev = devlib.resolve(device)
        self._set_params(params)
        self._hf_tokenizer = None
        self._tk = None
        self._custom_tokenize = tokenize_fn
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.dim = dim
        return self

    @staticmethod
    def random_params(vocab_size: int = 1024, dim: int = 384,
                      n_layers: int = 6, n_heads: int = 12,
                      intermediate: int = 1536, max_pos: int = 512,
                      seed: int = 0) -> dict:
        """Architecture-correct random weights (MiniLM-L6 shapes by
        default), numpy, from `seed`: the reference's draw, array for
        array."""
        rng = np.random.default_rng(seed)

        def w(*shape):
            return (rng.normal(size=shape) * 0.02).astype(np.float32)

        p = {
            "embeddings.word_embeddings.weight": w(vocab_size, dim),
            "embeddings.position_embeddings.weight": w(max_pos, dim),
            "embeddings.token_type_embeddings.weight": w(2, dim),
            "embeddings.LayerNorm.weight": np.ones(dim, np.float32),
            "embeddings.LayerNorm.bias": np.zeros(dim, np.float32),
        }
        for i in range(n_layers):
            pre = f"encoder.layer.{i}."
            for nm, shape in (
                    ("attention.self.query", (dim, dim)),
                    ("attention.self.key", (dim, dim)),
                    ("attention.self.value", (dim, dim)),
                    ("attention.output.dense", (dim, dim)),
                    ("intermediate.dense", (intermediate, dim)),
                    ("output.dense", (dim, intermediate))):
                p[pre + nm + ".weight"] = w(*shape)
                p[pre + nm + ".bias"] = np.zeros(shape[0], np.float32)
            for nm in ("attention.output.LayerNorm", "output.LayerNorm"):
                p[pre + nm + ".weight"] = np.ones(dim, np.float32)
                p[pre + nm + ".bias"] = np.zeros(dim, np.float32)
        return p

    def reload(self) -> None:
        self._load()

    def _tokenize(self, texts: list[str]):
        if self._custom_tokenize is not None:
            return self._custom_tokenize(texts)
        if self._tk is not None:
            encs = self._tk.encode_batch(texts)
            T = max(len(e.ids) for e in encs)
            ids = np.zeros((len(encs), T), np.int32)
            mask = np.zeros((len(encs), T), np.float32)
            for i, e in enumerate(encs):
                ids[i, : len(e.ids)] = e.ids
                mask[i, : len(e.ids)] = e.attention_mask[: len(e.ids)]
            return ids, mask
        toks = self._hf_tokenizer(texts, padding="max_length",
                                  truncation=True, max_length=self.MAX_LEN,
                                  return_tensors="np")
        return (toks["input_ids"].astype(np.int32),
                toks["attention_mask"].astype(np.float32))

    def forward(self, ids, mask) -> torch.Tensor:
        """[B, T] ids and mask (numpy or tensors) -> [B, dim] f32 on the
        encoder's device."""
        ids = torch.as_tensor(np.asarray(ids) if not isinstance(
            ids, torch.Tensor) else ids).to(self.dev).long()
        mask = torch.as_tensor(np.asarray(mask, np.float32) if not
                               isinstance(mask, torch.Tensor)
                               else mask).to(self.dev).float()
        with torch.inference_mode():
            return bert_forward(self.params, ids, mask,
                                n_layers=self.n_layers, n_heads=self.n_heads,
                                pooling=self.pooling)

    def _fwd(self, params, ids, mask) -> np.ndarray:
        """The reference's `_fwd(params, ids, mask)`, as numpy."""
        with torch.inference_mode():
            return bert_forward(
                params, torch.as_tensor(np.asarray(ids)).to(self.dev).long(),
                torch.as_tensor(np.asarray(mask, np.float32)).to(self.dev),
                n_layers=self.n_layers, n_heads=self.n_heads,
                pooling=self.pooling).cpu().numpy()

    def encode(self, texts: list[str]) -> np.ndarray:
        ids, mask = self._tokenize(texts)
        ids, mask = np.asarray(ids), np.asarray(mask, np.float32)
        # T padded to a power of two (8 .. MAX_LEN), as the reference pads
        # it for its compiled programs; padding is masked out
        T = ids.shape[1]
        Tp = 8
        while Tp < T:
            Tp *= 2
        Tp = min(Tp, self.MAX_LEN)
        if Tp > T:
            ids = np.pad(ids, ((0, 0), (0, Tp - T)))
            mask = np.pad(mask, ((0, 0), (0, Tp - T)))
        elif Tp < T:
            ids, mask = ids[:, :Tp], mask[:, :Tp]
        return self.forward(ids, mask).cpu().numpy()


def _layer_norm(x, w, b, eps=1e-12):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def bert_forward(p: dict[str, Any], ids: torch.Tensor, mask: torch.Tensor,
                 *, n_layers: int, n_heads: int,
                 pooling: str = "mean") -> torch.Tensor:
    """[B, T] ids -> [B, dim] pooled L2-normalised embeddings."""
    B, T = ids.shape
    emb = (p["embeddings.word_embeddings.weight"][ids]
           + p["embeddings.position_embeddings.weight"][:T][None]
           + p["embeddings.token_type_embeddings.weight"][0][None, None])
    x = _layer_norm(emb, p["embeddings.LayerNorm.weight"],
                    p["embeddings.LayerNorm.bias"])
    D = x.shape[-1]
    hd = D // n_heads
    att_bias = (1.0 - mask)[:, None, None, :] * -1e9

    for i in range(n_layers):
        pre = f"encoder.layer.{i}."

        def lin(name, y):
            return y @ p[pre + name + ".weight"].T + p[pre + name + ".bias"]

        q = lin("attention.self.query", x).reshape(B, T, n_heads, hd)
        k = lin("attention.self.key", x).reshape(B, T, n_heads, hd)
        v = lin("attention.self.value", x).reshape(B, T, n_heads, hd)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores + att_bias, dim=-1)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, D)
        attn_out = lin("attention.output.dense", ctx)
        x = _layer_norm(x + attn_out,
                        p[pre + "attention.output.LayerNorm.weight"],
                        p[pre + "attention.output.LayerNorm.bias"])
        ffn = F.gelu(lin("intermediate.dense", x), approximate="none")
        ffn = lin("output.dense", ffn)
        x = _layer_norm(x + ffn, p[pre + "output.LayerNorm.weight"],
                        p[pre + "output.LayerNorm.bias"])

    if pooling == "cls":
        pooled = x[:, 0]
    else:
        m = mask[:, :, None]
        pooled = (x * m).sum(1) / torch.clamp_min(m.sum(1), 1e-9)
    return pooled / torch.clamp_min(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)

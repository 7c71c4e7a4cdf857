"""Symmetric int8 scalar quantizer, the PyTorch port of
kektordb_tpu/ops/quantize.py.

The codes equal the reference's bit for bit: the scale is the same
float32 quotient, the product is one float32 multiply, and `torch.round`
rounds half to even like `jnp.rint`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Reference constants (quantizer.go:49-134)
_SAMPLE_FRACTION = 0.10
_SAMPLE_MAX = 25_000
_SAMPLE_MIN = 10_000
_PERCENTILE = 0.999


class QuantizerState(NamedTuple):
    abs_max: torch.Tensor   # 0-dim float32, on the index's device
    trained: bool

    @property
    def scale(self) -> torch.Tensor:
        return 127.0 / torch.clamp_min(self.abs_max, 1e-12)


def empty_state(device="cpu") -> QuantizerState:
    return QuantizerState(torch.tensor(0.0, device=device), False)


def train(vectors: torch.Tensor) -> QuantizerState:
    """Outlier-robust AbsMax: the 99.9th percentile of |values| over a
    stride sample (10% of the rows, at least 10k, at most 25k)."""
    n = vectors.shape[0]
    want = int(min(max(n * _SAMPLE_FRACTION, _SAMPLE_MIN), _SAMPLE_MAX))
    want = min(want, n)
    stride = max(n // want, 1)
    flat = torch.sort(torch.abs(vectors[::stride].float().reshape(-1)))[0]
    idx = round(_PERCENTILE * (flat.shape[0] - 1))
    return QuantizerState(torch.clamp_min(flat[idx], 1e-12), True)


def _codes(scaled: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    codes = torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)
    return codes, torch.linalg.vector_norm(codes.float(), dim=-1)


def quantize(state: QuantizerState, vectors: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """[.., D] f32 -> (int8 codes, int-domain L2 norms [..] f32)."""
    return _codes(vectors.float() * state.scale)


def dequantize(state: QuantizerState, codes: torch.Tensor) -> torch.Tensor:
    return codes.float() * (state.abs_max / 127.0)


def quantize_rowwise(vectors: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row-scale int8 for cosine arenas: codes = round(127 x / max|x_r|).
    Cosine scoring divides by |codes|, so the row scale cancels and is not
    stored. Zero rows code to zeros."""
    v = vectors.float()
    rowmax = torch.amax(torch.abs(v), dim=-1, keepdim=True)
    return _codes(v * (127.0 / torch.clamp_min(rowmax, 1e-12)))


def fit_pca_basis(sample, p: int) -> np.ndarray:
    """Top-p PCA directions of a host sample, centered. [D, p] float32."""
    s = np.asarray(sample, np.float32)
    s = s - s.mean(axis=0, keepdims=True)
    _, vecs = np.linalg.eigh(s.T @ s)
    return vecs[:, -p:][:, ::-1].astype(np.float32)

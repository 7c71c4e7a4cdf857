"""Model weights fetch with SHA256 verification.

Reference: pkg/embeddings/download.go — download the MiniLM checkpoint from
HuggingFace, verify the digest, cache locally. Zero-egress environments
never reach the network: `fetch_model` is only invoked when the local cache
misses AND the caller opted into network fetches (KEKTOR_ALLOW_DOWNLOAD=1).
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

log = logging.getLogger("kektordb.download")

HF_BASE = "https://huggingface.co/{model}/resolve/main/{fname}"

# all-MiniLM-L6-v2 artifacts. The weights digest is pinned via env/config
# at deployment (this build environment has no network to verify one
# against the published repo — shipping an unverifiable constant would be
# worse than requiring the operator to pin it): set KEKTOR_MINILM_SHA256.
MINILM_FILES = {
    "model.safetensors": os.environ.get("KEKTOR_MINILM_SHA256") or None,
    "config.json": None,
    "tokenizer.json": None,
}


def default_cache_dir() -> str:
    return os.environ.get(
        "KEKTOR_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "kektordb",
                     "models"))


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_model(model: str = "sentence-transformers/all-MiniLM-L6-v2",
                dest: Optional[str] = None,
                files: Optional[dict[str, Optional[str]]] = None,
                timeout: float = 120.0) -> str:
    """Download model files into dest (default cache dir), verifying SHA256
    where a digest is pinned. Returns the model directory. Raises on
    digest mismatch (the file is removed) or network failure."""
    import requests

    files = files or MINILM_FILES
    d = os.path.join(dest or default_cache_dir(), model.replace("/", "__"))
    os.makedirs(d, exist_ok=True)
    for fname, digest in files.items():
        path = os.path.join(d, fname)
        if os.path.exists(path):
            if digest is None or sha256_file(path) == digest:
                continue
            log.warning("digest mismatch for cached %s; re-downloading",
                        fname)
            os.remove(path)
        url = HF_BASE.format(model=model, fname=fname)
        if digest is None and fname.endswith(".safetensors"):
            # weights fetched without a pinned digest is a supply-chain
            # exposure — loud by design (set KEKTOR_MINILM_SHA256 to pin)
            log.warning(
                "downloading %s WITHOUT SHA256 verification "
                "(KEKTOR_MINILM_SHA256 unset)", fname)
        log.info("downloading %s", url)
        r = requests.get(url, timeout=timeout, stream=True)
        r.raise_for_status()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(1 << 20):
                f.write(chunk)
        if digest is not None:
            got = sha256_file(tmp)
            if got != digest:
                os.remove(tmp)
                raise ValueError(
                    f"SHA256 mismatch for {fname}: got {got}, "
                    f"want {digest}")
        os.replace(tmp, path)
    return d


def local_model_dir(model: str = "sentence-transformers/all-MiniLM-L6-v2",
                    dest: Optional[str] = None) -> Optional[str]:
    """Return the cached model dir if all files are present (no network)."""
    d = os.path.join(dest or default_cache_dir(), model.replace("/", "__"))
    if all(os.path.exists(os.path.join(d, f)) for f in MINILM_FILES):
        return d
    return None

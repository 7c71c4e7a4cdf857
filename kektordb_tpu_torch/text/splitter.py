"""Text splitters: recursive-character, markdown, code, fixed.

Reference: pkg/rag/splitter.go:22-231 + pkg/core/text/chunker.go."""

from __future__ import annotations

import re

DEFAULT_CHUNK = 1000
DEFAULT_OVERLAP = 150


def split_fixed(text: str, chunk_size: int = DEFAULT_CHUNK,
                overlap: int = DEFAULT_OVERLAP) -> list[str]:
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    step = max(chunk_size - overlap, 1)
    return [text[i:i + chunk_size] for i in range(0, max(len(text), 1), step)
            if text[i:i + chunk_size].strip()]


def split_recursive(text: str, chunk_size: int = DEFAULT_CHUNK,
                    overlap: int = DEFAULT_OVERLAP,
                    separators: list[str] | None = None) -> list[str]:
    """Recursive-character splitting: try big separators first, recurse into
    oversized pieces with finer ones (splitter.go:22-120)."""
    seps = separators or ["\n\n", "\n", ". ", " ", ""]

    def rec(t: str, level: int) -> list[str]:
        if len(t) <= chunk_size:
            return [t] if t.strip() else []
        if level >= len(seps):
            return split_fixed(t, chunk_size, overlap)
        sep = seps[level]
        if sep == "":
            return split_fixed(t, chunk_size, overlap)
        parts = t.split(sep)
        out: list[str] = []
        buf = ""
        for part in parts:
            cand = (buf + sep + part) if buf else part
            if len(cand) <= chunk_size:
                buf = cand
            else:
                if buf.strip():
                    out.append(buf)
                if len(part) > chunk_size:
                    out.extend(rec(part, level + 1))
                    buf = ""
                else:
                    buf = part
        if buf.strip():
            out.append(buf)
        return out

    chunks = rec(text, 0)
    if overlap > 0 and len(chunks) > 1:
        with_ov = [chunks[0]]
        for prev, cur in zip(chunks, chunks[1:]):
            with_ov.append(prev[-overlap:] + cur if overlap else cur)
        return with_ov
    return chunks


_MD_HEADING = re.compile(r"^(#{1,6})\s", re.MULTILINE)


def split_markdown(text: str, chunk_size: int = DEFAULT_CHUNK,
                   overlap: int = DEFAULT_OVERLAP) -> list[str]:
    """Split at headings, then recursively within sections
    (splitter.go markdown mode)."""
    positions = [m.start() for m in _MD_HEADING.finditer(text)] + [len(text)]
    if not positions or positions[0] != 0:
        positions = [0] + positions
    out = []
    for a, b in zip(positions, positions[1:]):
        section = text[a:b]
        if len(section) <= chunk_size:
            if section.strip():
                out.append(section)
        else:
            out.extend(split_recursive(section, chunk_size, overlap))
    return out


_CODE_SEPS = ["\nclass ", "\ndef ", "\nfunc ", "\nfn ", "\n\n", "\n", " ", ""]


def split_code(text: str, chunk_size: int = DEFAULT_CHUNK,
               overlap: int = DEFAULT_OVERLAP) -> list[str]:
    return split_recursive(text, chunk_size, overlap, separators=_CODE_SEPS)


SPLITTERS = {
    "recursive": split_recursive,
    "markdown": split_markdown,
    "code": split_code,
    "fixed": split_fixed,
}


def get_splitter(kind: str):
    if kind not in SPLITTERS:
        raise ValueError(f"unknown splitter: {kind}")
    return SPLITTERS[kind]

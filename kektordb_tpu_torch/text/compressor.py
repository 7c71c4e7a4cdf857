"""Lexical context compressor ("caveman" compression).

Reference: pkg/textanalyzer/compressor.go:73-212 — drops low-information
words (articles, auxiliaries, fillers) while PRESERVING negations, logical
operators, numbers, casing and code-like tokens; targets a 20-35% token
reduction without changing meaning (DOCUMENTATION.md:606)."""

from __future__ import annotations

import re

# words that are safe to drop (never negations/operators/quantifiers)
_DROPPABLE = frozenset("""
a an the of that which this these those is are was were be been being am
very really quite just simply basically actually certainly definitely
perhaps maybe somewhat rather fairly pretty also too as well indeed
it its there here then thus hence
""".split())

# never drop: negations, operators, quantifiers, conditionals
_PROTECTED = frozenset("""
not no never none nor neither cannot can't won't don't doesn't didn't isn't
aren't wasn't weren't shouldn't couldn't wouldn't mustn't without unless
if else and or but nor xor all any some few many most every each only
except must should shall may might will
""".split())

_TOKEN_RE = re.compile(r"\S+")
_WORD_RE = re.compile(r"^[A-Za-z]+$")


def compress(text: str) -> str:
    """Drop droppable words; keep protected words, numbers, punctuation,
    code-like tokens, and anything capitalized mid-sentence (names)."""
    out: list[str] = []
    tokens = _TOKEN_RE.findall(text)
    for i, tok in enumerate(tokens):
        bare = tok.strip(".,;:!?\"'()[]{}").lower()
        if bare in _PROTECTED:
            out.append(tok)
            continue
        if bare in _DROPPABLE and _WORD_RE.match(tok.strip(".,;:!?\"'()[]{}")):
            # keep sentence-initial capitalized droppables ("The server...")
            # only if they carry the capital into a heading-like context
            if tok[0].isupper() and i > 0:
                out.append(tok)
            continue
        out.append(tok)
    return " ".join(out)


def compression_ratio(original: str, compressed: str) -> float:
    o = len(_TOKEN_RE.findall(original)) or 1
    c = len(_TOKEN_RE.findall(compressed))
    return 1.0 - c / o

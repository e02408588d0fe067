"""Word-error-rate scoring for the seed-test style quality sweeps.

The reference repo publishes WER numbers (README.md:56-84) but ships no
scorer; this implements the standard protocol those tables use: normalise
(case-fold, strip punctuation, split CJK into chars / latin into words),
then Levenshtein distance over the token sequences.
"""
from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence

import numpy as np

_PUNCT = re.compile(
    r"[　-〿＀-￯!\"#$%&'()*+,\-./:;<=>?@\[\]^_`{|}~«»…—–‘’“”]")


def _is_cjk(ch: str) -> bool:
    return ("一" <= ch <= "鿿" or "㐀" <= ch <= "䶿"
            or "豈" <= ch <= "﫿")


def normalize_for_wer(text: str) -> List[str]:
    """Case-fold, drop punctuation, CJK → per-char tokens, latin → words."""
    text = unicodedata.normalize("NFKC", text).lower()
    text = _PUNCT.sub(" ", text)
    tokens: List[str] = []
    word = ""
    for ch in text:
        if _is_cjk(ch):
            if word:
                tokens.append(word)
                word = ""
            tokens.append(ch)
        elif ch.isspace():
            if word:
                tokens.append(word)
                word = ""
        else:
            word += ch
    if word:
        tokens.append(word)
    return tokens


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance (substitution/insertion/deletion, all cost 1)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (np.array([ref[i - 1] != h for h in hyp]))
        dele = prev[1:] + 1
        # insertion needs a sequential pass (depends on cur[j-1])
        best = np.minimum(sub, dele)
        run = cur[0]
        for j in range(1, m + 1):
            run = min(run + 1, best[j - 1])
            cur[j] = run
        prev = cur
    return int(prev[m])


def wer(ref_text: str, hyp_text: str) -> float:
    """WER in [0, inf): edit distance / reference length (CJK char-level,
    latin word-level — the seed-test convention)."""
    ref = normalize_for_wer(ref_text)
    hyp = normalize_for_wer(hyp_text)
    if not ref:
        return 0.0 if not hyp else float(len(hyp))
    return edit_distance(ref, hyp) / len(ref)

"""Plain-text parser: sentence segmentation → zero-timestamp SRT entries
(spec: srt_dubbing/src/txt_parser.py, pysbd replaced by a self-contained
splitter)."""
from __future__ import annotations

import re
from pathlib import Path
from typing import List

from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTEntry

# common sentence-internal abbreviations (pysbd-style protection; the
# reference delegates to pysbd — txt_parser.py:7-53)
_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc",
    "ltd", "co", "corp", "e.g", "i.e", "eg", "ie", "a.m", "p.m", "u.s",
    "u.k", "no", "vol", "fig", "dept", "est", "approx", "jan", "feb", "mar",
    "apr", "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec",
}
_CLOSERS = "”’\"')】》]"
_WORD_BEFORE = re.compile(r"([A-Za-z][A-Za-z.]*)$")


def split_sentences(text: str) -> List[str]:
    """Sentence segmentation with abbreviation / decimal / initial /
    ellipsis awareness ('Dr. Smith', '3.5', 'J. K.', '...' stay intact)."""
    out: List[str] = []
    start, i, n = 0, 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "。！？；":
            j = i + 1
            while j < n and text[j] in _CLOSERS:
                j += 1
            out.append(text[start:j])
            start = i = j
            continue
        if ch in ".!?;":
            if ch == ".":
                # decimal point (3.5) — not a boundary
                if (0 < i < n - 1 and text[i - 1].isdigit()
                        and text[i + 1].isdigit()):
                    i += 1
                    continue
                m = _WORD_BEFORE.search(text[start:i])
                word = m.group(1).lower() if m else ""
                # abbreviation or single-letter initial — not a boundary
                if word in _ABBREVIATIONS or (len(word) == 1 and word.isalpha()):
                    i += 1
                    continue
            j = i + 1
            while j < n and text[j] in ".!?。！？":    # ... / ?! runs
                j += 1
            # period/ellipsis followed by a lowercase word continues the
            # sentence ("Wait... really?") — pysbd behaviour
            if text[j - 1] == ".":
                k = j
                while k < n and text[k] == " ":
                    k += 1
                if k < n and text[k].isalpha() and text[k].islower():
                    i = j
                    continue
            while j < n and text[j] in _CLOSERS:
                j += 1
            out.append(text[start:j])
            start = i = j
            continue
        i += 1
    if text[start:].strip():
        out.append(text[start:])
    return [s.strip() for s in out if s.strip()]


class TXTParser:
    def parse_file(self, file_path: str) -> List[SRTEntry]:
        p = Path(file_path)
        if not p.exists():
            raise FileNotFoundError(f"TXT file not found: {file_path}")
        try:
            content = p.read_text(encoding="utf-8")
        except UnicodeDecodeError:
            content = p.read_text(encoding="gbk")
        return self.parse_content(content)

    def parse_content(self, content: str) -> List[SRTEntry]:
        sentences = split_sentences(content.replace("\n", " "))
        return [SRTEntry(index=i + 1, start_time=0.0, end_time=0.0, text=s)
                for i, s in enumerate(sentences)]

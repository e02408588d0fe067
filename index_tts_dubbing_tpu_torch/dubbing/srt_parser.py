"""SRT subtitle parser (spec: srt_dubbing/src/srt_parser.py)."""
from __future__ import annotations

import re
from pathlib import Path
from typing import List, NamedTuple

from index_tts_dubbing_tpu_torch.dubbing.logger import get_logger


class SRTEntry(NamedTuple):
    index: int
    start_time: float  # seconds
    end_time: float
    text: str

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


class SRTParser:
    TIME_PATTERN = re.compile(
        r"(\d{2}):(\d{2}):(\d{2}),(\d{3})\s*-->\s*"
        r"(\d{2}):(\d{2}):(\d{2}),(\d{3})")

    def __init__(self):
        self.entries: List[SRTEntry] = []

    @staticmethod
    def time_to_seconds(h: int, m: int, s: int, ms: int) -> float:
        return h * 3600 + m * 60 + s + ms / 1000.0

    @staticmethod
    def seconds_to_time(total: float) -> str:
        h = int(total // 3600)
        m = int((total % 3600) // 60)
        s = int(total % 60)
        ms = int((total % 1) * 1000)
        return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"

    def parse_file(self, file_path: str) -> List[SRTEntry]:
        p = Path(file_path)
        if not p.exists():
            raise FileNotFoundError(f"SRT file not found: {file_path}")
        try:
            content = p.read_text(encoding="utf-8")
        except UnicodeDecodeError:
            content = p.read_text(encoding="gbk")
        return self.parse_content(content)

    def parse_content(self, content: str) -> List[SRTEntry]:
        entries: List[SRTEntry] = []
        for block in content.strip().split("\n\n"):
            lines = block.strip().split("\n")
            if len(lines) < 3:
                continue
            try:
                index = int(lines[0].strip())
                m = self.TIME_PATTERN.match(lines[1].strip())
                if not m:
                    raise ValueError(f"bad timestamp: {lines[1].strip()}")
                g = [int(x) for x in m.groups()]
                entries.append(SRTEntry(
                    index=index,
                    start_time=self.time_to_seconds(*g[:4]),
                    end_time=self.time_to_seconds(*g[4:]),
                    text="\n".join(lines[2:]).strip()))
            except (ValueError, IndexError) as e:
                raise ValueError(f"failed to parse SRT block: "
                                 f"{block[:50]}... error: {e}")
        self.entries = entries
        get_logger().success(f"parsed {len(entries)} SRT entries")
        return entries

    def validate_entries(self, entries: List[SRTEntry]) -> bool:
        if not entries:
            return False
        for i, e in enumerate(entries):
            if e.start_time < 0 or e.end_time < 0:
                return False
            if e.start_time >= e.end_time:
                return False
            if not e.text.strip():
                return False
            if i > 0 and e.start_time < entries[i - 1].end_time:
                get_logger().warning(
                    f"entry {e.index} overlaps the previous entry")
        return True

    def get_total_duration(self) -> float:
        return max((e.end_time for e in self.entries), default=0.0)

    def filter_by_time_range(self, start: float, end: float) -> List[SRTEntry]:
        return [e for e in self.entries
                if e.end_time > start and e.start_time < end]

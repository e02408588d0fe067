"""Leveled colored logger + process logger (spec: srt_dubbing/src/logger.py)."""
from __future__ import annotations

import sys
import time
from typing import Optional

try:
    from colorama import Fore, Style, init as _colorama_init
    _colorama_init()
    _C = {"debug": Fore.CYAN, "info": "", "step": Fore.BLUE,
          "success": Fore.GREEN, "warning": Fore.YELLOW, "error": Fore.RED}
    _RESET = Style.RESET_ALL
except Exception:  # colorama optional
    _C = {k: "" for k in ("debug", "info", "step", "success", "warning", "error")}
    _RESET = ""

_ICONS = {"debug": "·", "info": "i", "step": "→", "success": "✓",
          "warning": "⚠", "error": "✗"}
_LEVELS = {"debug": 10, "info": 20, "step": 20, "success": 20,
           "warning": 30, "error": 40}


class DubbingLogger:
    def __init__(self, level: str = "info", stream=None):
        self.min_level = _LEVELS.get(level, 20)
        self.stream = stream or sys.stderr

    def _log(self, kind: str, msg: str):
        if _LEVELS[kind] < self.min_level:
            return
        ts = time.strftime("%H:%M:%S")
        print(f"{_C[kind]}[{ts}] {_ICONS[kind]} {msg}{_RESET}",
              file=self.stream)

    def debug(self, msg): self._log("debug", msg)
    def info(self, msg): self._log("info", msg)
    def step(self, msg): self._log("step", msg)
    def success(self, msg): self._log("success", msg)
    def warning(self, msg): self._log("warning", msg)
    def error(self, msg): self._log("error", msg)


_logger: Optional[DubbingLogger] = None


def setup_logging(level: str = "info") -> DubbingLogger:
    global _logger
    _logger = DubbingLogger(level)
    return _logger


def get_logger() -> DubbingLogger:
    global _logger
    if _logger is None:
        _logger = DubbingLogger()
    return _logger


class ProcessLogger:
    """start / progress / complete flow logger."""

    def __init__(self, description: str):
        self.description = description
        self.log = get_logger()
        self.t0 = None

    def start(self, msg: str = ""):
        self.t0 = time.perf_counter()
        self.log.step(f"{self.description}: {msg}")

    def progress(self, current: int, total: int, msg: str = ""):
        pct = 100.0 * current / max(total, 1)
        self.log.info(f"{self.description} {current}/{total} ({pct:.1f}%) {msg}")

    def complete(self, msg: str = ""):
        dt = time.perf_counter() - (self.t0 or time.perf_counter())
        self.log.success(f"{self.description} done in {dt:.1f}s. {msg}")


def create_process_logger(description: str) -> ProcessLogger:
    return ProcessLogger(description)

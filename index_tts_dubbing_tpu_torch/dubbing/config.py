"""Dubbing configuration constants (spec: srt_dubbing/src/config.py)."""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict


class AudioConfig:
    DEFAULT_SAMPLE_RATE = 22050
    DEFAULT_CHANNELS = 1
    AUDIO_NORMALIZATION_FACTOR = 32768.0
    DYNAMIC_BUFFER_SIZE = 1024
    MAX_AMPLITUDE = 1.0
    DEFAULT_FADE_DURATION = 0.1
    DEFAULT_GAP_DURATION = 0.1


class StrategyConfig:
    TIME_STRETCH_THRESHOLD = 0.05
    TIME_DURATION_TOLERANCE = 0.1
    MAX_SPEED_RATIO = 1.5
    MIN_SPEED_RATIO = 0.7
    HIGH_QUALITY_MAX_SPEED = 1.3
    HIGH_QUALITY_MIN_SPEED = 0.8
    SILENCE_THRESHOLD = 0.5
    BASIC_MAX_SPEED_RATIO = 1.2
    BASIC_MIN_SPEED_RATIO = 0.8


class LogConfig:
    PROGRESS_TEXT_PREVIEW_LENGTH = 20


class IndexTTSConfig:
    MODEL_DIR = "checkpoints"
    CONFIG_FILE = "checkpoints/config.yaml"
    FP16 = False

    @classmethod
    def get_init_kwargs(cls) -> Dict[str, Any]:
        kw: Dict[str, Any] = {"is_fp16": cls.FP16}
        if Path(cls.CONFIG_FILE).exists():
            kw["cfg_path"] = cls.CONFIG_FILE
        if Path(cls.MODEL_DIR).exists():
            kw["model_dir"] = cls.MODEL_DIR
        return kw


class PathConfig:
    DEFAULT_OUTPUT = "outputs/dubbed_audio.wav"

    @classmethod
    def get_default_output_path(cls) -> str:
        return cls.DEFAULT_OUTPUT


AUDIO = AudioConfig
STRATEGY = StrategyConfig
LOG = LogConfig
PATH = PathConfig

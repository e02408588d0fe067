"""Tiny i18n helper for the web UI (spec: tools/i18n/i18n.py)."""
from __future__ import annotations

import json
import locale
from pathlib import Path
from typing import Dict, Optional

LOCALE_DIR = Path(__file__).parent / "locale"

_BUILTIN: Dict[str, Dict[str, str]] = {
    "zh_CN": {
        "Reference audio": "参考音频",
        "Text": "文本",
        "Generate": "生成",
        "Output": "输出",
        "Infer mode": "推理模式",
        "standard": "普通推理",
        "batch": "批次推理",
        "Advanced sampling options": "高级采样设置",
    },
}


class I18nAuto:
    def __init__(self, language: Optional[str] = None):
        if language in (None, "Auto"):
            language = locale.getdefaultlocale()[0] or "en_US"
        self.language = language
        self.map: Dict[str, str] = {}
        path = LOCALE_DIR / f"{language}.json"
        if path.exists():
            self.map = json.loads(path.read_text(encoding="utf-8"))
        elif language in _BUILTIN:
            self.map = _BUILTIN[language]

    def __call__(self, key: str) -> str:
        return self.map.get(key, key)

"""Web-UI helpers: html snippets and sentence-preview pagination
(spec: indextts/utils/webui_utils.py). Gradio is an optional dependency."""
from __future__ import annotations

PAGE_SIZE = 20


def html_center(text: str, label: str = "p") -> str:
    return (f'<div style="text-align: center; margin: 100; padding: 50;">'
            f'<{label} style="margin: 0; padding: 0;">{text}</{label}></div>')


def html_left(text: str, label: str = "p") -> str:
    return (f'<div style="text-align: left; margin: 0; padding: 0;">'
            f'<{label} style="margin: 0; padding: 0;">{text}</{label}></div>')


def page_slice(page_number: int, items):
    start = (int(page_number) - 1) * PAGE_SIZE
    end = min(int(page_number) * PAGE_SIZE, len(items))
    return items[start:end]


def next_page(page_number: int, items):
    """Returns (new_page, has_next, has_prev)."""
    new_page = int(page_number) + 1
    return new_page, len(items) > new_page * PAGE_SIZE, True


def prev_page(page_number: int):
    new_page = int(page_number) - 1
    return new_page, True, new_page > 1

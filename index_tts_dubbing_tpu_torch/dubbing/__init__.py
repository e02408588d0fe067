"""SRT/TXT dubbing application layer.

Behavioural spec: srt_dubbing/src of the reference — parsers → time-sync
strategy (plugin registry) → TTS engine (plugin registry) → audio processor
(merge/export). Strategies receive an injected engine (dependency injection,
strategies/__init__.py:40-60 in the reference).
"""

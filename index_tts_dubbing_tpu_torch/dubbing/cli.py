"""Dubbing CLI: 5-stage pipeline — engine init → parse SRT/TXT → strategy →
per-entry synthesis → merge + export (spec: srt_dubbing/src/cli.py:25-177;
TXT input forces the basic strategy, like the reference)."""
from __future__ import annotations

import argparse
import sys
import time

from index_tts_dubbing_tpu_torch.dubbing.audio_processor import AudioProcessor
from index_tts_dubbing_tpu_torch.dubbing.config import PATH
from index_tts_dubbing_tpu_torch.dubbing.engines import TTS_ENGINES, get_tts_engine
from index_tts_dubbing_tpu_torch.dubbing.logger import get_logger, setup_logging
from index_tts_dubbing_tpu_torch.dubbing.srt_parser import SRTParser
from index_tts_dubbing_tpu_torch.dubbing.strategies import (
    get_strategy, get_strategy_description, list_available_strategies)
from index_tts_dubbing_tpu_torch.dubbing.txt_parser import TXTParser


def build_parser() -> argparse.ArgumentParser:
    strategies = list_available_strategies()
    parser = argparse.ArgumentParser(
        description="SRT/TXT subtitle dubbing (IndexTTS on the GPU)",
        formatter_class=argparse.RawTextHelpFormatter)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--srt", help="input SRT subtitle file")
    group.add_argument("--txt", help="input plain-text file")
    parser.add_argument("--voice", required=True, help="reference voice wav")
    parser.add_argument("--output", default=PATH.get_default_output_path(),
                        help="output audio path")
    parser.add_argument(
        "--strategy", default="stretch", choices=strategies,
        help="time-sync strategy:\n" + "\n".join(
            f"  - {s}: {get_strategy_description(s)}" for s in strategies))
    parser.add_argument("--tts-engine", default="index_tts",
                        choices=sorted(TTS_ENGINES))
    parser.add_argument("--model-dir", default=None,
                        help="checkpoint directory for the TTS engine")
    parser.add_argument("--cfg-path", default=None, help="engine config yaml")
    parser.add_argument("--sample-rate", type=int, default=None,
                        help="output sample rate (default: engine native)")
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging("debug" if args.verbose else "info")
    log = get_logger()
    t0 = time.perf_counter()

    # 1. engine
    try:
        engine_kwargs = {}
        if args.tts_engine == "index_tts":
            if args.model_dir:
                engine_kwargs["model_dir"] = args.model_dir
            if args.cfg_path:
                engine_kwargs["cfg_path"] = args.cfg_path
        engine = get_tts_engine(args.tts_engine, **engine_kwargs)
        log.success(f"TTS engine ready: {args.tts_engine}")
    except Exception as e:
        log.error(f"engine init failed: {e}")
        return 1

    # 2. parse input
    try:
        if args.srt:
            parser = SRTParser()
            entries = parser.parse_file(args.srt)
            if not parser.validate_entries(entries):
                log.warning("SRT validation reported problems; continuing")
            strategy_name = args.strategy
        else:
            entries = TXTParser().parse_file(args.txt)
            strategy_name = "basic"  # TXT has no timing info
            if args.strategy != "basic":
                log.info("TXT input: forcing 'basic' strategy")
    except Exception as e:
        log.error(f"input parse failed: {e}")
        return 1
    if not entries:
        log.error("no entries to synthesize")
        return 1

    # 3. strategy
    try:
        strategy = get_strategy(strategy_name, engine)
    except Exception as e:
        log.error(f"strategy init failed: {e}")
        return 1

    # 4. synthesis
    segments = strategy.process_entries(entries,
                                        voice_reference=args.voice,
                                        verbose=args.verbose)

    # 5. merge + export
    sr = args.sample_rate
    if sr is None and hasattr(engine, "tts"):
        sr = engine.tts.cfg.mel.sample_rate
    processor = AudioProcessor(sample_rate=sr)
    merged = processor.merge_audio_segments(segments,
                                            strategy_name=strategy_name,
                                            verbose=args.verbose)
    if not processor.export_audio(merged, args.output):
        return 1
    log.success(f"done in {time.perf_counter() - t0:.1f}s → {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Single-utterance synthesis CLI (spec: indextts/cli.py:7-59)."""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="IndexTTS (PyTorch/CUDA) command line interface",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("text", help="text to synthesize")
    parser.add_argument("-v", "--voice", required=True,
                        help="reference voice wav")
    parser.add_argument("-o", "--output_path", default="gen.wav")
    parser.add_argument("-c", "--config", default="checkpoints/config.yaml")
    parser.add_argument("--model_dir", default="checkpoints")
    parser.add_argument("--fp16", action="store_true",
                        help="bf16 weights and compute on the GPU")
    parser.add_argument("--fast", action="store_true",
                        help="use bucketed batched inference (infer_fast)")
    parser.add_argument("-f", "--force", action="store_true",
                        help="overwrite existing output")
    args = parser.parse_args(argv)

    if not os.path.exists(args.voice):
        print(f"voice file not found: {args.voice}", file=sys.stderr)
        return 1
    if os.path.exists(args.output_path) and not args.force:
        print(f"output exists: {args.output_path} (use --force)",
              file=sys.stderr)
        return 1

    from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
    cfg_path = args.config if os.path.exists(args.config) else None
    model_dir = args.model_dir if os.path.isdir(args.model_dir) else None
    tts = IndexTTS(cfg_path=cfg_path, model_dir=model_dir,
                   is_fp16=args.fp16)
    infer = tts.infer_fast if args.fast else tts.infer
    infer(args.voice, args.text, args.output_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

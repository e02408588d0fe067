"""Gradio web UI (spec: webui.py of the reference: prompt upload, normal vs
batch inference, sampling controls, sentence-split preview, examples).

Gradio is optional in this environment; ``build_demo`` raises a clear error
when it's missing, and ``main`` exits with guidance.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from index_tts_dubbing_tpu_torch.utils.i18n import I18nAuto


def build_demo(tts, i18n=None, cases_path: str | None = None):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("the web UI requires the optional 'gradio' "
                          "package") from e
    i18n = i18n or I18nAuto()

    def gen_single(prompt, text, infer_mode, max_text_tokens_per_sentence,
                   sentences_bucket_max_size, do_sample, top_p, top_k,
                   temperature, length_penalty, num_beams,
                   repetition_penalty, max_mel_tokens,
                   progress=gr.Progress()):
        tts.gr_progress = progress
        kwargs = dict(do_sample=bool(do_sample), top_p=float(top_p),
                      top_k=int(top_k), temperature=float(temperature),
                      length_penalty=float(length_penalty),
                      num_beams=int(num_beams),
                      repetition_penalty=float(repetition_penalty),
                      max_mel_tokens=int(max_mel_tokens))
        if infer_mode == i18n("standard"):
            return tts.infer(prompt, text, None,
                             max_text_tokens_per_sentence=int(
                                 max_text_tokens_per_sentence), **kwargs)
        return tts.infer_fast(prompt, text, None,
                              max_text_tokens_per_sentence=int(
                                  max_text_tokens_per_sentence),
                              sentences_bucket_max_size=int(
                                  sentences_bucket_max_size), **kwargs)

    def on_input_text_change(text, max_tokens_per_sentence):
        if not text.strip():
            return gr.update(value=[])
        tokens = tts.tokenizer.tokenize(text)
        sentences = tts.tokenizer.split_sentences(
            tokens, int(max_tokens_per_sentence))
        return gr.update(value=[[i, "".join(s), len(s)]
                                for i, s in enumerate(sentences)])

    with gr.Blocks(title="IndexTTS") as demo:
        gr.Markdown("# IndexTTS — zero-shot TTS on the GPU")
        with gr.Row():
            prompt = gr.Audio(label=i18n("Reference audio"), type="filepath")
            with gr.Column():
                # model version surfaced like the reference (webui.py:117)
                text = gr.TextArea(
                    label=i18n("Text"),
                    info=f"model version {tts.model_version or '1.0'}")
                infer_mode = gr.Radio(
                    [i18n("standard"), i18n("batch")],
                    value=i18n("standard"), label=i18n("Infer mode"))
                gen_btn = gr.Button(i18n("Generate"), variant="primary")
        with gr.Accordion(i18n("Advanced sampling options"), open=False):
            do_sample = gr.Checkbox(value=True, label="do_sample")
            top_p = gr.Slider(0.0, 1.0, value=0.8, label="top_p")
            top_k = gr.Slider(0, 100, value=30, step=1, label="top_k")
            temperature = gr.Slider(0.1, 2.0, value=1.0, label="temperature")
            length_penalty = gr.Number(value=0.0, label="length_penalty")
            num_beams = gr.Slider(1, 10, value=3, step=1, label="num_beams")
            repetition_penalty = gr.Number(value=10.0,
                                           label="repetition_penalty")
            max_mel_tokens = gr.Slider(50, 600, value=600, step=10,
                                       label="max_mel_tokens")
            max_text_tokens = gr.Slider(20, 300, value=120, step=2,
                                        label="max_text_tokens_per_sentence")
            bucket_size = gr.Slider(1, 16, value=4, step=1,
                                    label="sentences_bucket_max_size")
        preview = gr.Dataframe(headers=["#", "sentence", "tokens"],
                               label="sentence split preview")
        output = gr.Audio(label=i18n("Output"))
        text.change(on_input_text_change, [text, max_text_tokens], [preview])
        gen_btn.click(
            gen_single,
            [prompt, text, infer_mode, max_text_tokens, bucket_size,
             do_sample, top_p, top_k, temperature, length_penalty, num_beams,
             repetition_penalty, max_mel_tokens],
            [output])
        if cases_path and Path(cases_path).exists():
            examples = []
            for line in Path(cases_path).read_text(encoding="utf-8").splitlines():
                case = json.loads(line)
                examples.append([case.get("prompt_audio"), case.get("text")])
            gr.Examples(examples=examples, inputs=[prompt, text])
    return demo


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="IndexTTS web UI (PyTorch/CUDA)")
    parser.add_argument("--model_dir", default="checkpoints")
    parser.add_argument("--cfg_path", default="checkpoints/config.yaml")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--fp16", action="store_true")
    args = parser.parse_args(argv)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio is not installed; `pip install gradio` to use the "
              "web UI", file=sys.stderr)
        return 1
    from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS
    tts = IndexTTS(
        cfg_path=args.cfg_path if os.path.exists(args.cfg_path) else None,
        model_dir=args.model_dir if os.path.isdir(args.model_dir) else None,
        is_fp16=args.fp16)
    demo = build_demo(tts)
    demo.queue().launch(server_name=args.host, server_port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())

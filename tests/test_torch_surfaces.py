"""The port's user surfaces: every test of tests/test_surfaces.py against the
port's modules (CLI argument handling, web UI gating, i18n, paging), then
the single-utterance CLI and the dubbing CLI end to end on the CPU on a
model directory (a small config.yaml and gpt.npz + bigvgan.npz written from
the JAX package's init tree), with the engine the CLIs build moved to the
CPU, as the tests run it."""
import builtins
import sys

import jax
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu_torch.engine import tts as ptts
from index_tts_dubbing_tpu_torch.utils import checkpoint
from index_tts_dubbing_tpu_torch.utils.audio import write_wav

# the small config of tests/test_torch_engine.py, with a 48-step decode cap
CONFIG_YAML = """version: 1.5
gpt:
  model_dim: 64
  layers: 2
  heads: 4
  max_mel_tokens: 48
  max_text_tokens: 130
  number_text_tokens: 120
  condition_module:
    output_size: 32
    linear_units: 64
    attention_heads: 4
    num_blocks: 2
bigvgan:
  gpt_dim: 64
  upsample_initial_channel: 128
"""
SRT_THREE = """1
00:00:00,000 --> 00:00:01,200
Hello there friend.

2
00:00:01,500 --> 00:00:02,400
第二段字幕来了

3
00:00:02,600 --> 00:00:04,000
The quick brown fox jumps.
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ tests/test_surfaces.py


def test_cli_missing_voice(tmp_path, capsys):
    from index_tts_dubbing_tpu_torch import cli
    rc = cli.main(["hello", "-v", str(tmp_path / "nope.wav")])
    assert rc == 1
    assert "not found" in capsys.readouterr().err


def test_cli_no_overwrite(tmp_path, capsys):
    from index_tts_dubbing_tpu_torch import cli
    voice = tmp_path / "v.wav"
    write_wav(voice, np.zeros(100, np.float32), 24000)
    out = tmp_path / "o.wav"
    out.write_bytes(b"x")
    rc = cli.main(["hello", "-v", str(voice), "-o", str(out)])
    assert rc == 1
    assert "exists" in capsys.readouterr().err


def test_webui_gated_without_gradio(monkeypatch):
    from index_tts_dubbing_tpu_torch import webui
    real_import = builtins.__import__

    def block_gradio(name, *a, **k):
        if name == "gradio":
            raise ImportError("no gradio")
        return real_import(name, *a, **k)

    monkeypatch.delitem(sys.modules, "gradio", raising=False)
    monkeypatch.setattr(builtins, "__import__", block_gradio)
    with pytest.raises(ImportError):
        webui.build_demo(object())
    assert webui.main([]) == 1


def test_i18n():
    from index_tts_dubbing_tpu_torch.utils.i18n import I18nAuto
    zh = I18nAuto("zh_CN")
    assert zh("Generate") == "生成"
    assert zh("unmapped key") == "unmapped key"
    en = I18nAuto("en_US")
    assert en("Generate") == "Generate"


def test_webui_utils_paging():
    from index_tts_dubbing_tpu_torch.utils import webui_utils as w
    items = list(range(45))
    assert w.page_slice(1, items) == list(range(20))
    assert w.page_slice(3, items) == list(range(40, 45))
    page, has_next, has_prev = w.next_page(1, items)
    assert (page, has_next, has_prev) == (2, True, True)
    page, has_next, has_prev = w.next_page(2, items)
    assert (page, has_next) == (3, False)
    assert "center" in w.html_center("x")


# ------------------------------------------------ the CLIs on a model dir


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """config.yaml, gpt.npz and bigvgan.npz of the small config, and a
    random 1 s voice."""
    d = tmp_path_factory.mktemp("model")
    (d / "config.yaml").write_text(CONFIG_YAML)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    gpt = jgpt.GPTConfig(model_dim=64, layers=2, heads=4, max_mel_tokens=48,
                         max_text_tokens=130, number_text_tokens=120,
                         cond_output_size=32, cond_linear_units=64,
                         cond_attention_heads=4, cond_num_blocks=2)
    bv = jbigvgan.BigVGANConfig(gpt_dim=64, upsample_initial_channel=128)
    tree = jax.tree_util.tree_map(np.asarray, {"gpt": jgpt.init(k1, gpt),
                                               "bigvgan": jbigvgan.init(k2, bv)})
    checkpoint.save_params(d / "gpt.npz", tree["gpt"])
    checkpoint.save_params(d / "bigvgan.npz", tree["bigvgan"])
    rng = np.random.default_rng(1)
    write_wav(d / "voice.wav", (rng.standard_normal(24000) * 0.1
                                ).astype(np.float32), 24000)
    return d, tree


@pytest.fixture
def cpu_engines(monkeypatch):
    """Every IndexTTS the surfaces build runs on the CPU, counted: returns
    the list of engines built and the list of their infer/infer_batch
    calls."""
    built, calls = [], []

    class CpuTTS(ptts.IndexTTS):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, device="cpu", **kwargs)
            built.append(self)

        def infer(self, *args, **kwargs):
            calls.append("infer")
            return super().infer(*args, **kwargs)

        def infer_batch(self, *args, **kwargs):
            calls.append("infer_batch")
            return super().infer_batch(*args, **kwargs)

    monkeypatch.setattr(ptts, "IndexTTS", CpuTTS)
    return built, calls


def read_i16(path):
    import wave
    with wave.open(str(path), "rb") as w:
        assert w.getsampwidth() == 2 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), "<i2"), \
            w.getframerate()


@pytest.mark.parametrize("flags", [[], ["--fast", "--fp16"]])
def test_cli_synthesizes_from_a_model_dir(model_dir, cpu_engines, tmp_path,
                                          flags):
    """indextts-torch on a model directory: the engine loads its weights and
    config (bf16 with --fp16), runs infer (or infer_fast with --fast) with
    the reference's default beam sampling, and writes int16 at 24 kHz of
    whole frames, not constant."""
    from index_tts_dubbing_tpu_torch import cli
    d, tree = model_dir
    built, calls = cpu_engines
    out = tmp_path / "gen.wav"
    rc = cli.main(["Hello there friend.", "-v", str(d / "voice.wav"),
                   "-o", str(out), "-c", str(d / "config.yaml"),
                   "--model_dir", str(d), *flags])
    assert rc == 0 and len(built) == 1
    tts = built[0]
    assert tts.gpt_cfg.max_mel_tokens == 48
    dtype = torch.bfloat16 if "--fp16" in flags else torch.float32
    assert torch.equal(tts.params["gpt"]["mel_head"]["w"],
                       torch.from_numpy(tree["gpt"]["mel_head"]["w"]).to(dtype))
    assert calls == ([] if "--fast" in flags else ["infer"])
    assert tts.last_times.decode.startswith("beam sampling (num_beams=3")
    wav, sr = read_i16(out)
    assert sr == 24000 and wav.size and wav.size % 1024 == 0
    assert wav.min() < wav.max()


def test_dubbing_cli_stretch_from_a_model_dir(model_dir, cpu_engines,
                                              tmp_path):
    """srt-dubbing-torch on three SRT entries (one Chinese) with the stretch
    strategy: one infer_batch and no per-entry fallback, and the merged wav
    at 24 kHz sounds in every entry's span and reaches past the last one's
    end."""
    from index_tts_dubbing_tpu_torch.dubbing import cli
    d, _ = model_dir
    built, calls = cpu_engines
    srt = tmp_path / "in.srt"
    srt.write_text(SRT_THREE, encoding="utf-8")
    out = tmp_path / "dub.wav"
    rc = cli.main(["--srt", str(srt), "--voice", str(d / "voice.wav"),
                   "--output", str(out), "--model-dir", str(d),
                   "--cfg-path", str(d / "config.yaml"),
                   "--strategy", "stretch"])
    assert rc == 0 and len(built) == 1
    assert calls == ["infer_batch"]
    wav, sr = read_i16(out)
    assert sr == 24000 and wav.size >= int(4.0 * sr)
    for start, end in ((0.0, 1.2), (1.5, 2.4), (2.6, 4.0)):
        assert np.abs(wav[int(start * sr):int(end * sr)]).max() > 0


# ---------------------------------------------- the web UI's handlers


def _webui_handlers(monkeypatch, webui_mod, tts):
    """build_demo against a mocked gradio: the mock records every widget
    call, so the handlers come back from the ``.click`` and ``.change``
    registrations (gen_single, on_input_text_change) with the mock."""
    from unittest import mock
    gr = mock.MagicMock()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    webui_mod.build_demo(tts)
    gen_single = gr.Button.return_value.click.call_args.args[0]
    on_change = gr.TextArea.return_value.change.call_args.args[0]
    return gr, gen_single, on_change


def test_webui_handlers_match_jax(model_dir, monkeypatch):
    """The web UI's two handlers run on the small engine of each package:
    the sentence preview rows equal, and gen_single's int16 wav within
    2 LSB in both infer modes (greedy, num_beams 1, cap 16)."""
    from index_tts_dubbing_tpu import webui as jwebui
    from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
    from index_tts_dubbing_tpu_torch import webui as pwebui
    from index_tts_dubbing_tpu_torch.utils.i18n import I18nAuto
    d, _ = model_dir
    cfg = str(d / "config.yaml")
    jtts = JaxTTS(cfg_path=cfg, model_dir=str(d), verbose_init=False)
    ptts_ = ptts.IndexTTS(cfg_path=cfg, model_dir=str(d), device="cpu",
                          verbose_init=False)
    text = "Hello there friend. The quick brown fox jumps over the dog!"
    previews, wavs = [], []
    for webui_mod, tts in ((jwebui, jtts), (pwebui, ptts_)):
        gr, gen_single, on_change = _webui_handlers(monkeypatch, webui_mod,
                                                    tts)
        on_change(text, 20)
        previews.append(gr.update.call_args.kwargs["value"])
        on_change("   ", 20)
        assert gr.update.call_args.kwargs["value"] == []
        out = []
        for mode in ("standard", "batch"):
            sr, wav = gen_single(str(d / "voice.wav"), text, I18nAuto()(mode),
                                 20, 4, False, 0.8, 30, 1.0, 0.0, 1, 10.0, 16)
            assert sr == 24000 and wav.dtype == np.int16 and wav.size
            out.append(wav)
        assert tts.gr_progress is not None        # the handler's progress
        wavs.append(out)
    assert previews[0] == previews[1] and len(previews[1]) >= 2
    for jwav, pwav in zip(*wavs):
        assert pwav.shape == jwav.shape
        diff = np.abs(pwav.astype(np.int32) - jwav.astype(np.int32))
        assert diff.max() <= 2, diff.max()

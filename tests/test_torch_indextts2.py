"""IndexTTS-2 in the port against the benchmark's plain reference
(``perfbench/reference/indextts2.py``, ``v2_front.py``, ``v2_s2m.py``) on
the CPU, at a small size of the same shape on seeded random weights
(``perfbench/tests/data/tiny.v2.json``): GPT 64 wide, 2 layers, 4 heads;
both conditioners 32 wide with one conformer block; w2v-BERT 32 wide, 3
layers, hidden state 2 read; the codec 24 wide with 2 ConvNeXt blocks and
64 codes; CAM++ with 4-channel FCM and dense blocks of 2 layers; the S2M
DiT 32 wide, 5 blocks (two U-ViT skips), a 3-layer WaveNet head; 3 Euler
steps; the mel vocoder at 64 initial channels. Every kind of block is
present.

Tolerances: both sides compute in float32 on the CPU with the same
weights, so they differ only by the order of float32 operations (a padded
batch against one row, SDPA against an explicit softmax, a split input
projection against the concatenated one, the cached decode against one
full pass): ``FWD_TOL`` 1e-5 relative on one module's forward; ``DEEP_TOL``
1e-4 on what chains many (the logits after a cached decode, a whole guided
ODE of three steps, each guided forward amplifying the last one's rounding
by 1.7); the codec's codes equal (a random codebook's nearest code is far
from a tie).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from index_tts_dubbing_tpu_torch.engine.indextts2 import IndexTTS2
from index_tts_dubbing_tpu_torch.models import (campplus, gpt as gpt_model,
                                                s2m, semantic_codec, w2vbert)
from index_tts_dubbing_tpu_torch.ops import fbank
from index_tts_dubbing_tpu_torch.utils import audio as audio_util
from index_tts_dubbing_tpu_torch.utils import profiling
from perfbench.families import indextts2 as family
from perfbench.reference import indextts2 as ref_mod
from perfbench.reference import v2_front, v2_s2m

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 27
FWD_TOL = 1e-5
DEEP_TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(2)
    cfg = json.loads((ROOT / "perfbench" / "tests" / "data" /
                      "tiny.v2.json").read_text())
    params = family.make_weights(cfg, SEED, "cpu", torch.float32)
    v2 = family.v2_config(cfg)
    prompt = tmp_path_factory.mktemp("v2") / "prompt.wav"
    t = np.arange(int(0.6 * 22050)) / 22050
    wav = 0.3 * np.sin(2 * np.pi * 140 * t) * (1 + 0.3 * np.sin(
        2 * np.pi * 3 * t)) + 0.01 * np.random.default_rng(1).standard_normal(
        t.size)
    audio_util.write_wav(prompt, wav[None].astype(np.float32), 22050)
    ref = ref_mod.V2Reference(params, cfg)
    ref.set_prompt(prompt)
    eng = IndexTTS2(v2, params=params, device="cpu", seed=3,
                    vocoder_window=32, verbose_init=False)
    return cfg, params, v2, ref, eng, str(prompt)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_features_match_reference(setup):
    """torchaudio's resampler and both Kaldi filterbanks (w2v-BERT's
    normalised and stacked rows, CAM++'s mean-removed bands)."""
    *_, eng, prompt = setup
    wav = torch.as_tensor(audio_util.read_wav(prompt)[0][0])
    w16 = fbank.resample(wav, 22050, 16000)
    r16 = v2_front.resample(wav, 22050, 16000)
    assert w16.shape == r16.shape == (int(np.ceil(wav.numel() * 320 / 441)),)
    assert _rel(w16, r16) < FWD_TOL
    assert _rel(fbank.w2vbert_features(w16),
                v2_front.seamless_features(r16)) < FWD_TOL
    fb = v2_front.fbank(r16)
    assert _rel(fbank.campplus_features(w16),
                fb - fb.mean(0, keepdim=True)) < FWD_TOL


def test_w2vbert_layers_match_reference(setup):
    """Relative-key attention and the causal depthwise conv: the hidden
    state read, against the reference's, and a zero after the causal conv's
    right edge changes nothing before it."""
    cfg, params, v2, ref, *_ = setup
    feats = torch.randn(14, 160, generator=torch.Generator().manual_seed(4))
    got = w2vbert.encode(params["w2vbert"], v2.w2vbert, feats)
    want = v2_front.w2vbert(params["w2vbert"], ref.w2v, feats)
    assert got.shape == (1, 14, v2.w2vbert.hidden)
    assert _rel(got, want) < FWD_TOL
    p = params["w2vbert"]["layers"][0]["conv"]
    x = torch.randn(1, 10, v2.w2vbert.hidden)
    full = w2vbert.conv_module(p, v2.w2vbert, x)
    head = w2vbert.conv_module(p, v2.w2vbert, x[:, :6])
    assert torch.allclose(full[:, :6], head, atol=1e-6)   # causal


def test_codec_quantize_and_vq2emb(setup):
    cfg, params, v2, ref, *_ = setup
    x = torch.randn(1, 9, v2.codec.hidden_size,
                    generator=torch.Generator().manual_seed(5))
    emb, codes = semantic_codec.quantize(params["codec"], x)
    assert _rel(emb, v2_front.codec_quantize(params["codec"], x)) < FWD_TOL
    assert torch.equal(semantic_codec.vq2emb(params["codec"], codes)[0],
                       v2_front.vq2emb(params["codec"], codes[0]))
    assert int(codes.max()) < v2.codec.codebook_size


def test_campplus_matches_reference(setup):
    cfg, params, v2, ref, *_ = setup
    feat = torch.randn(130, 80, generator=torch.Generator().manual_seed(6))
    got = campplus.forward(params["campplus"], v2.campplus, feat[None])
    want = v2_front.campplus(params["campplus"], cfg["campplus"], feat)
    assert got.shape == (1, v2.campplus.embedding_size)
    assert _rel(got, want) < FWD_TOL


def test_conditioners_and_prefix(setup):
    """Both conditioners and the duration rows: the voice's 34 rows
    against the reference's, the prefix built around them."""
    cfg, params, v2, ref, eng, prompt = setup
    v = eng.voice(prompt)
    conds = eng.conds(v)
    assert conds.shape == (1, v2.gpt.condition_num_latent + 2,
                           v2.gpt.model_dim)
    assert _rel(conds, ref.conds) < FWD_TOL
    assert torch.equal(conds[0, -1], params["gpt"]["speed_emb"]["w"][0])
    pre = decode_mod.prepare_prefix_host(v2.gpt, [np.array([5, 6, 7])],
                                         cond_n=conds.shape[1])
    assert pre["ids"].shape == (1, conds.shape[1] + 5)
    assert (pre["seg"][0] == decode_mod.SEG_COND).sum() == conds.shape[1]


def test_emotion_vector_is_part_of_the_prefix(setup):
    """With the emotion vector left out, the conditioning rows move."""
    cfg, params, v2, ref, eng, prompt = setup
    v = eng.voice(prompt)
    f = v.feats.float()
    spk = gpt_model.get_conditioning(params["gpt"], v2.gpt, f,
                                     torch.tensor([f.shape[1]]))
    emo = gpt_model.emotion_vector(params["gpt"], f, v2.emo_attention_heads)
    assert _rel(gpt_model.v2_conds(params["gpt"], spk, 0 * emo),
                ref.conds) > 1e-3
    assert _rel(gpt_model.v2_conds(params["gpt"], spk, emo),
                ref.conds) < FWD_TOL


def test_cached_decode_logits_match_full_pass(setup):
    """Prefill then the cached ancestry step (the beam decode's), teacher
    forced along a row of codes: the logits before each code against the
    reference's one full causal pass."""
    cfg, params, v2, ref, eng, prompt = setup
    g, p = v2.gpt, params["gpt"]
    text = "ab cde."
    ids = eng.segments(text)[0]
    conds = eng.conds(eng.voice(prompt))
    codes = np.array([3, 17, 40, 8, 8, 29, 60, 1], np.int64)
    pre = decode_mod.prepare_prefix_host(g, [ids], cond_n=conds.shape[1])
    t = {k: torch.as_tensor(pre[k].astype(np.int64)) for k in pre}
    emb, keep = decode_mod.build_prefix_emb(p, g, conds, t["ids"], t["pos"],
                                            t["seg"], t["cond_idx"])
    s0, n = emb.shape[1], codes.size
    cache = gpt_model.SplitCache(
        *gpt_model.init_cache(g, 1, s0, torch.float32, "cpu"),
        *gpt_model.init_gen_cache_anc(g, 1, 1, n, torch.float32, "cpu"))
    h = gpt_model.trunk_prefill(p, g, emb, keep, gpt_model.KVCache(
        cache.kp, cache.vp))
    logits = [gpt_model.mel_logits_from_hidden(p, h)]
    amap = torch.zeros((1, 1, n), dtype=torch.long)
    for j in range(1, n):
        e = p["mel_emb"]["w"][codes[j - 1]] + p["mel_pos"]["w"][j + 1]
        h = gpt_model.trunk_decode_step_split_anc(p, g, e[None], cache, j - 1,
                                                  keep, 1, amap)
        logits.append(gpt_model.mel_logits_from_hidden(p, h))
    got = torch.cat(logits)
    want = ref.decode_logits(text, codes)
    assert got.shape == want.shape == (n, g.number_mel_codes)
    assert _rel(got, want) < DEEP_TOL


def test_gpt_layer_and_regulator_batch_rows_as_alone(setup):
    """``gpt_layer`` + ``vq2emb`` + the regulator over two rows of other
    lengths in one padded batch, each against the reference's row."""
    cfg, params, v2, ref, *_ = setup
    gen = torch.Generator().manual_seed(8)
    lat = torch.randn(2, 9, v2.gpt.model_dim, generator=gen)
    codes = [torch.randint(0, 64, (9,), generator=gen),
             torch.randint(0, 64, (5,), generator=gen)]
    p = params["s2m"]
    lrows = s2m.gpt_layer(p["gpt_layer"], lat)
    feats = [semantic_codec.vq2emb(params["codec"], c[None])[0]
             + lrows[i, : c.numel()] for i, c in enumerate(codes)]
    frames = [ref_mod.frames_of(c.numel(), 1.72) for c in codes]
    out, keep = s2m.regulate(p["regulator"], feats, frames)
    assert frames == [15, 8] and keep.sum(1).tolist() == frames
    for i, c in enumerate(codes):
        f = v2_s2m.gpt_layer(p["gpt_layer"], lat[i, : c.numel()]) \
            + v2_front.vq2emb(params["codec"], c)
        want = v2_s2m.regulate(p["regulator"], f[None], frames[i])[0]
        assert _rel(out[i, : frames[i]], want) < FWD_TOL
        assert not out[i, frames[i]:].any()


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "padded"])
def test_dit_forward_matches_reference(setup, ragged):
    """One guided DiT + WaveNet forward over a stacked batch: each row
    against the reference's published forward on that row alone (a padded
    row's keys masked, its WaveNet reflecting at its own end)."""
    cfg, params, v2, ref, *_ = setup
    sc, p = v2.s2m, params["s2m"]
    gen = torch.Generator().manual_seed(9)
    lens = [21, 13] if ragged else [21, 21]
    n = max(lens)
    x = torch.randn(2, n, sc.in_channels, generator=gen)
    px = torch.randn(2, n, sc.in_channels, generator=gen)
    mu = torch.randn(2, n, sc.content_dim, generator=gen)
    style = torch.randn(2, sc.style_dim, generator=gen)
    t = torch.tensor([0.0, 0.37])
    mods = s2m.modulations(p, sc, t)
    valid = pad = None
    if ragged:
        valid = torch.arange(n)[None] < torch.tensor(lens)[:, None]
        pad = s2m.reflect_index(lens, n, s2m.wavenet_pad(sc), "cpu")
    const = s2m.merge_const(p["dit"], sc, px, mu, style)
    got = s2m.forward(p, sc, x, const, s2m.step_mods(mods, 1), valid,
                      s2m.rotary(n, sc.hidden_dim // sc.num_heads, "cpu"),
                      pad)
    for i, m in enumerate(lens):
        want = v2_s2m.dit(p["dit"], ref.s2m, x[i: i + 1, :m].transpose(1, 2),
                          px[i: i + 1, :m].transpose(1, 2), t[1:],
                          style[i: i + 1], mu[i: i + 1, :m])
        assert _rel(got[i, :m], want[0].T) < FWD_TOL


def test_guided_ode_holds_the_prompt(setup):
    """The whole S2M of one row from its served codes and noise against
    the reference's ``solve_euler``; the prompt frames end at zero."""
    cfg, params, v2, ref, eng, prompt = setup
    v = eng.voice(prompt)
    text = "abc de."
    codes = np.array([5, 9, 33, 2, 2, 61, 7, 12, 40, 3], np.int64)
    rows = eng.segments(text)
    served = [codes]
    lat = eng._latents(eng.conds(v), rows, served)
    from index_tts_dubbing_tpu_torch.engine.indextts2 import V2Times
    mel, noise, durs = eng._s2m(v, served, lat, 77, V2Times())
    tp = v.ref_mel.shape[0]
    assert durs == [ref.frames(codes.size)]
    assert torch.equal(noise[0], ref.noise(77, durs[0]))
    want = ref.mel(text, codes, noise[0])
    assert not mel[0, :tp].any() and not want[:tp].any()
    assert _rel(mel[0, tp:], want[tp:]) < DEEP_TOL


def test_infer_batch_end_to_end(setup):
    """``infer_batch`` of two lines: every row's mel against the
    reference's S2M of its served codes, the wav against the reference's
    whole-line vocoding of that mel, each line at its own length."""
    cfg, params, v2, ref, eng, prompt = setup
    texts = ["ab cd.", "a longer line here."]
    outs = eng.infer_batch(prompt, texts, seed=11, max_mel_tokens=30,
                           num_beams=2)
    tp = eng.last_prompt_frames
    assert len(outs) == 2 and all(sr == 22050 for sr, _ in outs)
    for j, (text, codes) in enumerate(zip(texts, eng.last_codes)):
        n = eng.last_frames[j]
        assert n == ref.frames(codes.size)
        want = ref.mel(text, codes, ref.noise(11 + j, n))
        got = eng.last_mel[j, :n]
        assert _rel(got[tp:], want[tp:]) < DEEP_TOL
        wav = ref.vocode_i16(got[tp:])
        assert outs[j][1].shape == ((n - tp) * 256, 1)
        assert np.abs(outs[j][1][:, 0].astype(np.int32)
                      - wav.astype(np.int32)).max() <= 2
    assert eng.last_times.decode_steps == 30
    sr, one = eng.infer(prompt, texts[0], seed=11, max_mel_tokens=30,
                        num_beams=2)
    assert one.shape == ((eng.last_frames[0] - tp) * 256, 1)


def test_spans_record_under_a_profiler(setup):
    """One ``infer_batch`` under a CPU profiler is one request with every
    new span and attribute, the voice cached; untraced, nothing records
    and the wav is the same (the decode's generator reseeded)."""
    cfg, params, v2, ref, eng, prompt = setup
    profiling.clear()
    args = (prompt, ["ab cd.", "a longer line here."])
    kw = dict(seed=5, max_mel_tokens=12, num_beams=2)
    eng._generator.manual_seed(3)
    plain = eng.infer_batch(*args, **kw)
    assert profiling.requests() == []
    eng._generator.manual_seed(3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = eng.infer_batch(*args, **kw)
    (spans,) = profiling.requests()
    root = spans[0]
    n = max(eng.last_frames)
    assert root.name == "request" and root.attrs == {
        "entry": "infer_batch", "rows": 4, "decode_steps": 12,
        "s2m_rows": 4, "s2m_frames": 4 * n,
        "real_frames": 2 * sum(eng.last_frames), "nfe": 3,
        "graph_captures": 0}
    names = [s.name for s in spans]
    for name in ("v2.voice", "front", "v2.cond", "decode.prefill",
                 "decode.step", "latent", "s2m.regulate", "s2m.ode",
                 "sync", "gpt_gen", "s2m", "bigvgan"):
        assert name in names, name
    assert {"vocoder.plan", "vocoder.exact"} & set(names)
    voice = next(s for s in spans if s.name == "v2.voice")
    assert voice.attrs == {"cached": 1}
    ode = next(s for s in spans if s.name == "s2m.ode")
    steps = [s for s in spans if s.name == "s2m.nfe"]
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    assert all(s.parent == ode.id for s in steps)
    assert all({"graph", "anc_attn"} <= set(s.attrs) for s in spans
               if s.name == "decode.step")
    for (_, a), (_, b) in zip(plain, traced):
        assert np.array_equal(a, b)


def test_warpers_on_each_step(setup):
    """``warp_each_step``: a beam's candidates score its running score
    plus the step's warped log-probabilities (temperature 0.8), where the
    default warps the sum; at temperature 1 both keep the same sets."""
    cfg, params, v2, *_ = setup
    g = v2.gpt
    gen = torch.Generator().manual_seed(12)
    logp = torch.log_softmax(torch.randn(4, g.number_mel_codes,
                                         generator=gen), -1)
    bs = torch.tensor([-3.0, -5.0, -2.0, -9.0])
    out = {}
    for each in (False, True):
        sc = decode_mod.SamplingConfig(temperature=0.8, top_k=5,
                                       warp_each_step=each)
        beam = decode_mod._Beam(params["gpt"], g, sc, gen, 2, 0.0, True,
                                decode_mod._Rows(None, 2), 2, 8, "cpu",
                                torch.float32)
        cand, src, tok, _ = beam.select_candidates(logp, bs)
        rows = torch.arange(2)[:, None] * 2 + src
        out[each] = (cand, logp[rows, tok], bs[rows])
    cand, lp, b = out[True]
    assert torch.allclose(cand, lp / 0.8 + b)
    cand, lp, b = out[False]
    assert torch.allclose(cand, (lp + b) / 0.8)


def test_index_tts2_dubbing_engine(setup):
    """``get_tts_engine("index_tts2")`` on the port's engine at the small
    size: ``synthesize``, ``synthesize_batch`` on ``infer_batch``, and
    ``synthesize_to_duration`` through the code cap (a row that runs to its
    cap lasts the target to the hop); without weights it refuses."""
    from index_tts_dubbing_tpu_torch.dubbing.engines import get_tts_engine
    cfg, params, v2, ref, eng, prompt = setup
    dub = get_tts_engine("index_tts2", engine=eng)
    kw = {"voice_reference": prompt, "num_beams": 2, "seed": 4}
    wav, sr = dub.synthesize("ab cd.", max_mel_tokens=10, **kw)
    assert sr == 22050 and wav.dtype == np.float32 and wav.size > 0
    outs = dub.synthesize_batch(["one.", "two two."], max_mel_tokens=10,
                                **kw)
    assert len(outs) == 2 and all(w.size % 256 == 0 for w, _ in outs)
    wav, sr = dub.synthesize_to_duration("a line here.", 0.4, **kw)
    codes = eng.last_codes[0].size
    assert codes <= 20
    assert wav.size == int(np.float32(codes) * np.float32(1.72)) * 256
    if codes == 20:
        assert abs(wav.size / sr - 0.4) < 256 / sr + 0.02
    with pytest.raises(ValueError, match="weights"):
        get_tts_engine("index_tts2", config=v2, device="cpu")
    with pytest.raises(ValueError, match="voice_reference"):
        dub.synthesize("x.")

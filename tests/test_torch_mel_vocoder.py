"""BigVGAN's mel and the mel vocoder's ×256 window plan, on the CPU.

- the slaney filterbank and the whole log-mel against a direct numpy
  formula, and against the benchmark's reference;
- the ×256 chain's receptive field, measured by perturbing one input frame
  in float64, lies inside the halo ``receptive_frames`` derives, and the
  per-row window plan at that halo gives the exact route's wav (a halo of
  16, IndexTTS's, does not);
- IndexTTS's ×1024 vocoder gives bit for bit what it gave before the
  mel-vocoder form was added (frozen copies of the functions as they were).
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.config import BigVGANConfig, MelVocoderConfig
from index_tts_dubbing_tpu_torch.engine import vocoder as voc_mod
from index_tts_dubbing_tpu_torch.engine.vocoder import (WindowedVocoder,
                                                        receptive_frames)
from index_tts_dubbing_tpu_torch.models import bigvgan
from index_tts_dubbing_tpu_torch.ops.mel import BigVGANMel, slaney_filterbank
from perfbench.reference import f5tts as ref_mod

SMALL = MelVocoderConfig(upsample_initial_channel=64)


def _slaney_direct(sr, n_fft, n_mels):
    """librosa's slaney filterbank written out term by term: mel = 3f/200
    below 1 kHz, 15 + 27·ln(f/1000)/ln(6.4) above; triangles between
    n_mels + 2 points equally spaced in mel; each scaled by 2 / its width
    in Hz."""
    def mel(f):
        return 3.0 * f / 200.0 if f < 1000.0 else \
            15.0 + 27.0 * math.log(f / 1000.0) / math.log(6.4)

    def hz(m):
        return 200.0 * m / 3.0 if m < 15.0 else \
            1000.0 * math.exp((m - 15.0) * math.log(6.4) / 27.0)
    top = mel(sr / 2.0)
    pts = [hz(top * i / (n_mels + 1)) for i in range(n_mels + 2)]
    out = np.zeros((n_mels, n_fft // 2 + 1))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        for k in range(n_fft // 2 + 1):
            f = k * sr / n_fft
            w = min((f - lo) / (mid - lo), (hi - f) / (hi - mid))
            out[m, k] = max(0.0, w) * 2.0 / (hi - lo)
    return out


def test_slaney_filterbank_matches_direct_formula():
    got = slaney_filterbank(24000, 1024, 100)
    want = _slaney_direct(24000, 1024, 100)
    assert got.shape == (100, 513)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def _wav(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_bigvgan_mel_matches_numpy():
    """Reflect pad of (n_fft − hop)/2, frames every hop without centring,
    periodic hann, |rfft| with 1e-9 inside the root, the filterbank, log of
    clamp 1e-5: within float32 rounding of the FFT (1e-4 in log)."""
    wav = _wav(12345)
    got = BigVGANMel(device="cpu")(wav)[0].numpy()
    pad = (1024 - 256) // 2
    x = np.pad(wav.astype(np.float64), pad, mode="reflect")
    n = (x.size - 1024) // 256 + 1
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(1024) / 1024)
    frames = np.stack([x[i * 256: i * 256 + 1024] * win for i in range(n)])
    spec = np.fft.rfft(frames, axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    want = np.log(np.maximum(_slaney_direct(24000, 1024, 100) @ mag.T, 1e-5))
    assert got.shape == want.shape == (100, BigVGANMel(device="cpu")
                                       .frames(12345))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bigvgan_mel_matches_reference():
    """The port's mel (unfold + rfft) against the reference's
    (``torch.stft``), both float32."""
    wav = _wav(24000 * 2, seed=1)
    got = BigVGANMel(device="cpu")(wav)[0].T
    want = ref_mod.bigvgan_mel(torch.as_tensor(wav), {
        "sample_rate": 24000, "n_fft": 1024, "hop_length": 256,
        "win_length": 1024, "n_mels": 100})
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-4


def _params(cfg, dtype=torch.float32, seed=0):
    p = weights.init_bigvgan(weights.Init(torch.Generator().manual_seed(seed),
                                          "cpu"), cfg)
    return weights.cast_floating(p, dtype)


def test_receptive_field_lies_inside_the_derived_halo():
    """One input frame changed by 1 (float64, so nothing rounds away):
    every output frame it moves lies within ``receptive_frames``."""
    torch.set_num_threads(2)
    p = _params(SMALL, torch.float64)
    t, j = 101, 50
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, t, 100, generator=g, dtype=torch.float64)
    x2 = x.clone()
    x2[0, j] += 1.0
    with torch.no_grad():
        d = (bigvgan.generate(p, SMALL, x, None)
             - bigvgan.generate(p, SMALL, x2, None))[0]
    moved = torch.nonzero(d.reshape(t, 256).abs().amax(-1) > 0).flatten()
    before, after = receptive_frames(SMALL)
    assert j - int(moved.min()) <= before and int(moved.max()) - j <= after
    assert int(moved.max()) - j > 16       # more than IndexTTS's halo
    assert receptive_frames(SMALL) == receptive_frames(MelVocoderConfig())


@pytest.mark.parametrize("halo,exact", [(max(receptive_frames(SMALL)), True),
                                        (16, False)], ids=["derived", "16"])
def test_row_plan_equals_the_exact_route(halo, exact):
    """Two rows longer than window + 2·halo and one shorter, each its own
    stream: the plan (K1's and K2's plain versions, exact patches at each
    row's ends) against the generator over each whole row. At the derived
    halo they agree to float32 rounding (6.6e-7 at most here, on samples of
    magnitude below 1); at 16 a seam is off by 1.1e-5 (a third of an int16
    step: the field's outer frames weigh little)."""
    torch.set_num_threads(2)
    p = _params(SMALL)
    voc = WindowedVocoder(p, SMALL, window=24, halo=halo)
    lens = [150, 40, 131]
    g = torch.Generator().manual_seed(2)
    lat = torch.randn(3, 150, 100, generator=g)
    with torch.no_grad():
        outs = voc.stream_rows(lat, lens)
        for i, n in enumerate(lens):
            want = bigvgan.generate(p, SMALL, lat[i: i + 1, :n], None)[0]
            err = float((outs[i] - want).abs().max())
            assert outs[i].shape == want.shape
            if n <= voc.window + 2 * halo:
                assert err < 2e-6          # a short row runs whole
            else:
                assert (err < 2e-6) is exact, (i, err)


# -- IndexTTS's ×1024 vocoder as it was before the mel-vocoder form -------
def _conv1d_cm_before(p, x, *, dilation=1, padding=0):
    y = F.conv1d(x, p["w"].to(x.dtype).permute(2, 1, 0), padding=padding,
                 dilation=dilation)
    return y + p["b"].to(x.dtype)[:, None]


def _vocode_window_cmajor_before(params, cfg, latent, spk, use_pallas=True,
                                 fuse_resblocks=True, packed=None,
                                 exact_edge=False):
    if exact_edge:       # the exact route, as ``_vocode(exact=True)`` took it
        use_pallas = fuse_resblocks = False
    if spk.shape[0] == 1 and latent.shape[0] > 1:
        spk = spk.expand((latent.shape[0],) + spk.shape[1:])
    spk_cm = spk.transpose(1, 2)
    x = _conv1d_cm_before(params["conv_pre"], latent.transpose(1, 2),
                          padding=3)
    x = x + _conv1d_cm_before(params["cond_layer"], spk_cm)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = voc_mod._conv_transpose1d_cm(params["ups"][i], x, stride=u,
                                         padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer:
            x = x + _conv1d_cm_before(params["conds"][i], spk_cm)
        xs = None
        for j in range(cfg.num_kernels):
            idx = i * cfg.num_kernels + j
            rb = params["resblocks"][idx]
            kk = cfg.resblock_kernel_sizes[j]
            dils = tuple(cfg.resblock_dilation_sizes[j])
            if fuse_resblocks and x.shape[1] <= 128:
                w = (packed[idx] if packed is not None
                     else voc_mod.pack_resblock(rb, cfg, x.dtype))
                y = voc_mod.resblock_cmajor(x, *w, kk, dils)
            else:
                y = x
                for c1, c2, a1, a2, d in zip(rb["convs1"], rb["convs2"],
                                             rb["acts"][::2],
                                             rb["acts"][1::2], dils):
                    yt = voc_mod._act_cm(cfg, a1, y, use_pallas)
                    yt = _conv1d_cm_before(c1, yt, dilation=d,
                                           padding=(kk * d - d) // 2)
                    yt = voc_mod._act_cm(cfg, a2, yt, use_pallas)
                    yt = _conv1d_cm_before(c2, yt, padding=(kk - 1) // 2)
                    y = yt + y
            xs = y if xs is None else xs + y
        x = xs / cfg.num_kernels
    x = voc_mod._act_cm(cfg, params["act_post"], x, use_pallas)
    x = _conv1d_cm_before(params["conv_post"], x, padding=3)
    return torch.tanh(x)[:, 0, :]


def _generate_before(params, cfg, latent, spk):
    from index_tts_dubbing_tpu_torch import nn
    x = nn.conv1d(params["conv_pre"], latent, padding=3)
    x = x + nn.conv1d(params["cond_layer"], spk)
    for i in range(cfg.num_upsamples):
        u = cfg.upsample_rates[i]
        k = cfg.upsample_kernel_sizes[i]
        x = nn.conv_transpose1d(params["ups"][i], x, stride=u,
                                padding=(k - u) // 2)
        if cfg.cond_in_each_up_layer:
            x = x + nn.conv1d(params["conds"][i], spk)
        xs = None
        for j in range(cfg.num_kernels):
            rb = params["resblocks"][i * cfg.num_kernels + j]
            y = bigvgan._amp_block(cfg, rb, x, cfg.resblock_kernel_sizes[j],
                                   cfg.resblock_dilation_sizes[j])
            xs = y if xs is None else xs + y
        x = xs / cfg.num_kernels
    x = bigvgan._act(cfg, params["act_post"], x)
    x = nn.conv1d(params["conv_post"], x, padding=3)
    return torch.tanh(x)[..., 0]


def _stream_device_before(voc, lat, lens, spk):
    """``WindowedVocoder.stream_device`` as it was, with its window
    collection and edge patches written out."""
    lens = np.asarray(lens, np.int64)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    t = int(bounds[-1])
    flat = lat.to(voc.compute_dtype).reshape(-1, lat.shape[-1])
    mb, up, h = lat.shape[1], voc.upsample, voc.halo
    rows = np.repeat(np.arange(lens.size), lens)
    cols = np.arange(t) - np.repeat(bounds[:-1], lens)
    flatmap = torch.as_tensor(rows * mb + cols)
    full = voc.window + 2 * h
    out = torch.empty(t * up, dtype=torch.float32)
    for chunk in voc._plan_batches(voc._window_list(t)):
        idx = torch.stack([flatmap[lo: lo + full] for (_, _, lo) in chunk])
        wavs = voc._vocode(flat[idx], spk, exact=False).float()
        for i, (s, e, lo) in enumerate(chunk):
            off = s - lo
            out[s * up: e * up] = wavs[i, off * up: (off + e - s) * up]
    pw = 2 * h
    patches = torch.stack([flat[flatmap[0: pw]], flat[flatmap[t - pw: t]]])
    ewav = voc._vocode(patches, spk[:1], exact=True).float()
    out[: h * up] = ewav[0, : h * up]
    out[(t - h) * up: t * up] = ewav[1, h * up:]
    return out.numpy()


def test_indextts_vocoder_is_bit_identical(monkeypatch):
    """A seeded IndexTTS-structured BigVGAN (speaker input, tanh, conv_post
    bias, ×1024): the windowed stream on the kernels' route (the window
    function and the plan) and the exact channels-last generator give
    exactly what the functions gave before."""
    torch.set_num_threads(2)
    cfg = BigVGANConfig(upsample_initial_channel=64, gpt_dim=16)
    p = _params(cfg, seed=5)
    assert "cond_layer" in p and "b" in p["conv_post"]
    g = torch.Generator().manual_seed(6)
    lat = torch.randn(2, 40, 16, generator=g)
    spk = torch.randn(1, 1, cfg.speaker_embedding_dim, generator=g)
    with torch.no_grad():
        now = WindowedVocoder(p, cfg, window=16, halo=8).stream_device(
            lat, [40, 33], spk=spk)
        gen_now = bigvgan.generate(p, cfg, lat[:1, :20], spk)
        monkeypatch.setattr(voc_mod, "_vocode_window_cmajor",
                            _vocode_window_cmajor_before)
        before = _stream_device_before(
            WindowedVocoder(p, cfg, window=16, halo=8), lat, [40, 33], spk)
        gen_before = _generate_before(p, cfg, lat[:1, :20], spk)
    assert np.array_equal(now, before) and now.size == 73 * 1024
    assert torch.equal(gen_now, gen_before)


def test_mel_form_runs_on_every_window_layout():
    """The mel vocoder (no speaker input, the clamp, no conv_post bias) on
    the channels-last "ref" layout: its plan at the derived halo gives the
    exact generator's wav to float32 rounding (window seams reorder sums
    only)."""
    torch.set_num_threads(2)
    p = _params(SMALL)
    g = torch.Generator().manual_seed(3)
    lat = torch.randn(2, 100, 100, generator=g)
    with torch.no_grad():
        want = bigvgan.generate(p, SMALL, lat, None)
        voc = WindowedVocoder(p, SMALL, window=16, layout="ref",
                              halo=max(receptive_frames(SMALL)))
        assert lat.shape[1] > voc.window + 2 * voc.halo   # windows ran
        got = torch.stack(voc.stream_rows(lat, [100, 100]))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-6

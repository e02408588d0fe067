"""IndexTTS-2's voice front end in plain PyTorch, for the reference: the
16 kHz resampler, the two Kaldi filterbanks, w2v-BERT 2.0 up to hidden
state 17, the semantic codec's quantizer and CAM++.

Each block follows its public source, written from it here and not from
the program:

- ``resample``: torchaudio's ``functional/functional.py``
  (``_get_sinc_resample_kernel``, ``_apply_sinc_resample_kernel``;
  ``sinc_interp_hann``, lowpass filter width 6, rolloff 0.99), which
  ``infer_v2.py``'s ``torchaudio.transforms.Resample(sr, 16000)`` runs;
- ``fbank``: ``torchaudio.compliance.kaldi.fbank``'s defaults (povey
  window, pre-emphasis 0.97, DC removal, 512-point power spectrum, Kaldi
  mel banks from 20 Hz, log floored at float32's epsilon), which
  transformers' ``SeamlessM4TFeatureExtractor`` also computes (on the wav
  times 2^15, then normalised per band and stacked by two frames);
- ``w2vbert``: transformers' ``models/wav2vec2_bert/
  modeling_wav2vec2_bert.py`` (``Wav2Vec2BertFeatureProjection``,
  ``Wav2Vec2BertEncoderLayer``, ``Wav2Vec2BertSelfAttention`` with
  ``relative_key``, ``Wav2Vec2BertConvolutionModule``), in (B, T, C) and
  (B, C, T) as the source has them;
- ``codec_quantize`` / ``vq2emb``: amphion's ``RepCodec.quantize``
  (``VocosBackbone`` + Linear, then ``ResidualVQ`` of one
  ``FactorizedVectorQuantize`` with L2-normalised lookup);
- ``campplus``: 3D-Speaker's ``speakerlab/models/campplus/DTDNN.py`` and
  ``layers.py`` in inference (``FCM``, ``TDNNLayer``,
  ``CAMDenseTDNNBlock``, ``TransitLayer``, ``StatsPool``,
  ``DenseLayer``).

Weights come in the benchmark's tree (linear ``(Cin, Cout)``, conv1d
``(K, Cin/g, Cout)``, conv2d HWIO); ``_lin``, ``_conv`` and ``_conv2`` take them in
torch's layouts.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["w"].to(x.dtype).T,
                    None if "b" not in p else p["b"].to(x.dtype))


def _w1(p: Params, dtype) -> torch.Tensor:
    return p["w"].to(dtype).permute(2, 1, 0)              # (O, I/g, K)


def _conv(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    """Conv1d over (B, C, T)."""
    b = p.get("b")
    return F.conv1d(x, _w1(p, x.dtype), None if b is None else b.to(x.dtype),
                    **kw)


def _conv2(p: Params, x: torch.Tensor, **kw) -> torch.Tensor:
    """Conv2d over (B, C, H, W) with an HWIO kernel."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(x, w, None, **kw)


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["g"].to(x.dtype),
                        p["b"].to(x.dtype), eps)


def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in inference over dim 1."""
    return F.batch_norm(x, p["mean"].to(x.dtype), p["var"].to(x.dtype),
                        p["g"].to(x.dtype), p["b"].to(x.dtype), False, 0.0,
                        1e-5)


# -- features ----------------------------------------------------------------
def resample(wav: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """torchaudio's sinc resampler, wav (T,) float32."""
    if orig == new:
        return wav
    lowpass, rolloff = 6, 0.99
    gcd = math.gcd(orig, new)
    orig, new = orig // gcd, new // gcd
    base = min(orig, new) * rolloff
    width = math.ceil(lowpass * orig / base)
    idx = torch.arange(-width, width + orig, dtype=torch.float64,
                       device=wav.device)[None, None] / orig
    t = torch.arange(0, -new, -1, dtype=torch.float64,
                     device=wav.device)[:, None, None] / new + idx
    t *= base
    t = t.clamp_(-lowpass, lowpass)
    window = torch.cos(t * math.pi / lowpass / 2) ** 2
    t *= math.pi
    kernels = torch.where(t == 0, torch.tensor(1.0).to(t), t.sin() / t)
    kernels *= window * (base / orig)
    kernels = kernels.to(torch.float32)
    length = wav.shape[-1]
    x = F.pad(wav.float()[None], (width, width + orig))
    y = F.conv1d(x[:, None], kernels, stride=orig)
    y = y.transpose(1, 2).reshape(1, -1)
    return y[0, : int(math.ceil(new * length / orig))]


def fbank(wav: torch.Tensor, num_mel_bins: int = 80,
          sample_frequency: float = 16000.0) -> torch.Tensor:
    """Kaldi's log mel filterbank (frames, num_mel_bins)."""
    window_size, window_shift, padded = 400, 160, 512
    m = 1 + (wav.shape[0] - window_size) // window_shift
    strided = wav.as_strided((m, window_size), (window_shift, 1))
    strided = strided - strided.mean(dim=1, keepdim=True)
    offset = F.pad(strided.unsqueeze(0), (1, 0), mode="replicate").squeeze(0)
    strided = strided - 0.97 * offset[:, :-1]
    win = torch.hann_window(window_size, periodic=False, device=wav.device,
                            dtype=wav.dtype).pow(0.85)
    strided = F.pad(strided * win[None], (0, padded - window_size))
    spectrum = torch.fft.rfft(strided).abs().pow(2.0)
    mel_scale = lambda f: 1127.0 * math.log(1.0 + f / 700.0)
    lo, hi = mel_scale(20.0), mel_scale(0.5 * sample_frequency)
    delta = (hi - lo) / (num_mel_bins + 1)
    b = torch.arange(num_mel_bins, device=wav.device).unsqueeze(1)
    left, center, right = lo + b * delta, lo + (b + 1.0) * delta, \
        lo + (b + 2.0) * delta
    mel = 1127.0 * torch.log(1.0 + (sample_frequency / padded) * torch.arange(
        padded // 2, device=wav.device) / 700.0).unsqueeze(0)
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    banks = torch.max(torch.zeros(1, device=wav.device),
                      torch.min(up, down))
    banks = F.pad(banks, (0, 1)).to(wav.dtype)
    eps = torch.tensor(torch.finfo(torch.float).eps, device=wav.device)
    return torch.max(torch.mm(spectrum, banks.T), eps).log()


def seamless_features(wav16: torch.Tensor) -> torch.Tensor:
    """SeamlessM4TFeatureExtractor: (frames // 2, 160)."""
    x = fbank(wav16 * (2 ** 15))
    x = (x - x.mean(0, keepdim=True)) / torch.sqrt(
        x.var(0, unbiased=True, keepdim=True) + 1e-7)
    n = x.shape[0] // 2 * 2
    return x[:n].reshape(n // 2, 2 * x.shape[1])


# -- w2v-BERT 2.0 -------------------------------------------------------------
def _w2v_attention(p: Params, c: Dict[str, Any], x: torch.Tensor
                   ) -> torch.Tensor:
    b, t, d = x.shape
    h, hs = c["heads"], d // c["heads"]
    q = _lin(p["q"], x).view(b, -1, h, hs).transpose(1, 2)
    k = _lin(p["k"], x).view(b, -1, h, hs).transpose(1, 2)
    v = _lin(p["v"], x).view(b, -1, h, hs).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(hs)
    pos_l = torch.arange(t, device=x.device).view(-1, 1)
    pos_r = torch.arange(t, device=x.device).view(1, -1)
    distance = torch.clamp(pos_r - pos_l, -c["left_max_position"],
                           c["right_max_position"])
    pe = p["distance"]["w"][distance + c["left_max_position"]].to(q.dtype)
    rel = torch.einsum("bhld,lrd->bhlr", q, pe)
    scores = scores + rel / math.sqrt(hs)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, -1, h * hs)
    return _lin(p["o"], out)


def _w2v_conv(p: Params, c: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    h = _ln(p["ln"], x, c["eps"]).transpose(1, 2)
    h = F.glu(_conv(p["pw1"], h), dim=1)
    h = F.pad(h, (c["conv_kernel"] - 1, 0))
    h = _conv(p["dw"], h, groups=h.shape[1])
    h = _ln(p["dw_ln"], h.transpose(1, 2), c["eps"]).transpose(1, 2)
    h = _conv(p["pw2"], F.silu(h))
    return h.transpose(1, 2)


def _w2v_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _lin(p["out"], F.silu(_lin(p["inter"], x)))


def w2vbert(p: Params, c: Dict[str, Any], feats: torch.Tensor
            ) -> torch.Tensor:
    """Stacked features (T, 160) → ``hidden_states[out_layer]``
    normalised by the stats: (1, T, hidden)."""
    eps = c["eps"]
    x = _lin(p["proj"], _ln(p["proj_ln"], feats[None], eps))
    for lyr in p["layers"][: c["out_layer"]]:
        r = x
        x = _w2v_ffn(lyr["ffn1"], _ln(lyr["ffn1_ln"], x, eps)) * 0.5 + r
        r = x
        x = _w2v_attention(lyr["attn"], c, _ln(lyr["attn_ln"], x, eps)) + r
        x = x + _w2v_conv(lyr["conv"], c, x)
        r = x
        x = _w2v_ffn(lyr["ffn2"], _ln(lyr["ffn2_ln"], x, eps)) * 0.5 + r
        x = _ln(lyr["final_ln"], x, eps)
    st = p["stats"]
    return (x - st["mean"].to(x.dtype)) / st["std"].to(x.dtype)


# -- the semantic codec -----------------------------------------------------
def _vocos(p: Params, x: torch.Tensor) -> torch.Tensor:
    """VocosBackbone over (B, C, T) → (B, T, dim)."""
    x = _conv(p["embed"], x, padding=3)
    x = _ln(p["norm"], x.transpose(1, 2), 1e-6).transpose(1, 2)
    for blk in p["blocks"]:
        r = x
        y = _conv(blk["dw"], x, padding=3, groups=x.shape[1]).transpose(1, 2)
        y = _ln(blk["norm"], y, 1e-6)
        y = _lin(blk["pw2"], F.gelu(_lin(blk["pw1"], y)))
        y = blk["gamma"].to(y.dtype) * y
        x = r + y.transpose(1, 2)
    return _ln(p["final_norm"], x.transpose(1, 2), 1e-6)


def vq2emb(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """Codes (T,) → (T, hidden): the code's embedding, out-projected."""
    q = p["quantizer"]
    return _lin(q["out_project"], F.embedding(codes, q["codebook"]["w"]))


def codec_quantize(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """w2v-BERT features (1, T, hidden) → the quantized (1, T, hidden)."""
    x = _lin(p["out"], _vocos(p, feats.transpose(1, 2)))
    q = p["quantizer"]
    z_e = _lin(q["in_project"], x)[0]                     # (T, d)
    enc = F.normalize(z_e)
    book = F.normalize(q["codebook"]["w"].to(enc.dtype))
    dist = (enc.pow(2).sum(1, keepdim=True) - 2 * enc @ book.t()
            + book.pow(2).sum(1, keepdim=True).t())
    idx = (-dist).max(1)[1]
    return vq2emb(p, idx)[None]


# -- CAM++ ------------------------------------------------------------------
def _res_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = F.relu(_bn(p["bn1"], _conv2(p["conv1"], x, stride=(stride, 1),
                                      padding=1)))
    out = _bn(p["bn2"], _conv2(p["conv2"], out, padding=1))
    short = x if "shortcut" not in p else _bn(
        p["shortcut_bn"], _conv2(p["shortcut"], x, stride=(stride, 1)))
    return F.relu(out + short)


def _cam(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    k = p["local"]["w"].shape[0]
    y = _conv(p["local"], x, padding=(k - 1) // 2 * dilation,
              dilation=dilation)
    seg = F.avg_pool1d(x, kernel_size=100, stride=100, ceil_mode=True)
    shape = seg.shape
    seg = seg.unsqueeze(-1).expand(*shape, 100).reshape(*shape[:-1], -1)
    context = x.mean(-1, keepdim=True) + seg[..., : x.shape[-1]]
    context = F.relu(_conv(p["linear1"], context))
    return y * torch.sigmoid(_conv(p["linear2"], context))


def campplus(p: Params, c: Dict[str, Any], feat: torch.Tensor
             ) -> torch.Tensor:
    """Fbank less its mean (T, 80) → the embedding (1, embedding_size)."""
    x = feat[None].permute(0, 2, 1).unsqueeze(1)           # (1, 1, F, T)
    h = p["head"]
    out = F.relu(_bn(h["bn1"], _conv2(h["conv1"], x, padding=1)))
    for stage in h["layers"]:
        for i, blk in enumerate(stage):
            out = _res_block(blk, out, 2 if i == 0 else 1)
    out = F.relu(_bn(h["bn2"], _conv2(h["conv2"], out, stride=(2, 1),
                                      padding=1)))
    s = out.shape
    x = out.reshape(s[0], s[1] * s[2], s[3])
    x = F.relu(_bn(p["tdnn"]["bn"], _conv(p["tdnn"]["conv"], x, stride=2,
                                          padding=2)))
    for block, transit, dil in zip(p["blocks"], p["transits"],
                                   c["block_dilations"]):
        for lyr in block:
            y = _conv(lyr["linear1"], F.relu(_bn(lyr["bn1"], x)))
            y = _cam(lyr["cam"], F.relu(_bn(lyr["bn2"], y)), dil)
            x = torch.cat([x, y], dim=1)
        x = _conv(transit["conv"], F.relu(_bn(transit["bn"], x)))
    x = F.relu(_bn(p["out_bn"], x))
    stats = torch.cat([x.mean(dim=-1), x.std(dim=-1, unbiased=True)], dim=-1)
    return _bn(p["dense_bn"], _conv(p["dense"], stats.unsqueeze(-1)))[..., 0]

"""The port's DiscreteVAE (models/dvae.py) and SincConv (ops/sinc_conv.py)
held against the JAX package's on the CPU, in float32, with the same numpy
weights and inputs:

- dvae at a narrow config (tests/test_dvae.py:75-76's widths): codes equal,
  the decoded mel within 1e-5, ``forward_train``'s losses and
  reconstruction within 1e-5, ``ema_update``'s state and codebook within
  1e-6, ``discretization_loss`` within 1e-5; the port's own ``init``
  has JAX's tree; a tree from a fabricated reference state dict through
  ``utils/convert.py convert_dvae`` decodes as JAX's does;
- sinc_conv on the cases of tests/test_ecapa.py:70-90 (24 filters of 31
  taps at 16 kHz on (2, 1600)), with its init cutoffs and with random
  ones, over every padding mode, within 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.models import dvae as jdvae
from index_tts_dubbing_tpu.ops import sinc_conv as jsinc
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.models import dvae as pdvae
from index_tts_dubbing_tpu_torch.ops import sinc_conv as psinc
from index_tts_dubbing_tpu_torch.utils.convert import convert_dvae

# tests/test_dvae.py:75-76
DVAE_SMALL = dict(channels=100, num_tokens=128, hidden_dim=32,
                  num_resnet_blocks=1, codebook_dim=32, num_layers=2)
TOL = 1e-5
EMA_TOL = 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def dv():
    jcfg = jdvae.DVAEConfig(**DVAE_SMALL)
    jp = jax.tree.map(np.array, jdvae.init(jax.random.PRNGKey(0), jcfg))
    mel = np.random.default_rng(4).standard_normal((2, 16, 100)
                                                   ).astype(np.float32)
    return dict(jcfg=jcfg, jp=jp, cfg=pdvae.DVAEConfig(**DVAE_SMALL),
                p=weights.from_jax_params(jp, device="cpu"), mel=mel)


def test_codes_and_decode_match_jax(dv):
    codes = np.asarray(jdvae.get_codebook_indices(dv["jp"], dv["jcfg"],
                                                  dv["mel"]))
    got = pdvae.get_codebook_indices(dv["p"], dv["cfg"], t(dv["mel"]))
    assert got.shape == codes.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), codes)
    ref = np.asarray(jdvae.decode(dv["jp"], dv["jcfg"], codes))
    dec = pdvae.decode(dv["p"], dv["cfg"], got)
    assert dec.shape == ref.shape == (2, 16, 100)
    np.testing.assert_allclose(dec.numpy(), ref, atol=TOL, rtol=0)


def test_forward_train_and_ema_match_jax(dv):
    jl, jc, jr = jdvae.forward_train(dv["jp"], dv["jcfg"], dv["mel"])
    pl_, pc, pr = pdvae.forward_train(dv["p"], dv["cfg"], t(dv["mel"]))
    np.testing.assert_allclose(float(pl_), float(jl), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(pc), float(jc), atol=TOL, rtol=0)
    np.testing.assert_allclose(pr.detach().numpy(), np.asarray(jr), atol=TOL,
                               rtol=0)
    # autograd reaches the encoder through the straight-through estimator
    p = weights.from_jax_params(dv["jp"], device="cpu")
    w = p["enc_convs"][0]["w"].requires_grad_()
    loss, commit, _ = pdvae.forward_train(p, dv["cfg"], t(dv["mel"]))
    (loss + commit).backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert w.grad.abs().sum() > 0

    logits = np.asarray(jdvae.encode(dv["jp"], dv["jcfg"], dv["mel"]))
    codes = np.asarray(jdvae.quantize(dv["jp"], logits)[1])
    rng = np.random.default_rng(2)
    n, d = DVAE_SMALL["num_tokens"], DVAE_SMALL["codebook_dim"]
    state = (rng.random(n).astype(np.float32),
             rng.standard_normal((d, n)).astype(np.float32))
    jnew, jst = jdvae.ema_update(dv["jp"], jdvae.EMAState(*state), logits,
                                 codes)
    pnew, pst = pdvae.ema_update(dv["p"], pdvae.EMAState(*map(t, state)),
                                 t(logits), t(codes).long())
    for got, ref in ((pst.cluster_size, jst.cluster_size),
                     (pst.embed_avg, jst.embed_avg),
                     (pnew["codebook"]["embed"], jnew["codebook"]["embed"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=EMA_TOL,
                                   rtol=1e-6)
    assert pnew["enc_out"] is dv["p"]["enc_out"]     # the rest is shared
    soft = rng.random((2, 4, n)).astype(np.float32)
    np.testing.assert_allclose(
        float(pdvae.discretization_loss(t(soft), 2, 0.1)),
        float(jdvae.discretization_loss(soft, 2, 0.1)), atol=TOL, rtol=1e-6)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def test_init_tree_and_convert_dvae(dv):
    """The port's init draws JAX's tree; a reference state dict made from
    JAX's tree (each map of convert_dvae inverted) comes back through it
    and decodes as JAX does."""
    p0 = pdvae.init(dv["cfg"], torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(p0) == _shapes(dv["jp"])
    jp, cfg = dv["jp"], dv["jcfg"]
    sd = {}

    def conv(prefix, c):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(
            np.asarray(c["w"]).transpose(2, 1, 0))   # (K, Cin, Cout) → torch
        sd[f"{prefix}.bias"] = np.asarray(c["b"])

    def res(base, r):
        for key, idx in (("c1", 0), ("c2", 2), ("c3", 4)):
            conv(f"{base}.{idx}", r[key])

    nl, nr = cfg.num_layers, cfg.num_resnet_blocks
    for i in range(nl):
        conv(f"encoder.{i}.0", jp["enc_convs"][i])
        conv(f"decoder.{1 + nr + i}.0.conv", jp["dec_convs"][i])
    for i in range(nr):
        res(f"encoder.{nl + i}.net", jp["enc_res"][i])
        res(f"decoder.{1 + i}.net", jp["dec_res"][i])
    conv(f"encoder.{nl + nr}", jp["enc_out"])
    conv("decoder.0", jp["dec_in"])
    conv(f"decoder.{1 + nr + nl}", jp["dec_out"])
    sd["codebook.embed"] = np.asarray(jp["codebook"]["embed"])
    tree = weights.from_jax_params(convert_dvae(sd, nl, nr), device="cpu")
    assert _shapes(tree) == _shapes(jp)
    codes = np.array([[3, 77, 5, 120]])
    ref = np.asarray(jdvae.decode(jp, cfg, codes))
    np.testing.assert_allclose(
        pdvae.decode(tree, dv["cfg"], t(codes).long()).numpy(), ref,
        atol=TOL, rtol=0)


# tests/test_ecapa.py:76-85
SINC_K, SINC_OUT, SINC_SR = 31, 24, 16000


@pytest.mark.parametrize("params", ["init", "random"])
@pytest.mark.parametrize("padding,stride,dilation", [
    ("same", 1, 1), ("same", 2, 1), ("same", 1, 2), ("causal", 1, 1),
    ("valid", 3, 1)])
def test_sinc_conv_matches_jax(rng, params, padding, stride, dilation):
    jp = jsinc.init(SINC_OUT, SINC_K, SINC_SR)
    if params == "random":
        jp = {k: (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
              for k, v in jp.items()}
    pp = psinc.init(SINC_OUT, SINC_K, SINC_SR, device="cpu")
    for k in jp if params == "init" else ():
        np.testing.assert_array_equal(pp[k].numpy(), jp[k])
    x = rng.standard_normal((2, 1600)).astype(np.float32)
    kw = dict(kernel_size=SINC_K, sample_rate=SINC_SR, stride=stride,
              dilation=dilation, padding=padding)
    ref = np.asarray(jsinc.forward(jp, x, **kw))
    got = psinc.forward({k: t(v) for k, v in jp.items()}, t(x), **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_sinc_conv_two_input_channels(rng):
    """One filter bank shared over 2 input channels (grouped conv); an
    out/in ratio that does not divide raises."""
    jp = jsinc.init(SINC_OUT, SINC_K, SINC_SR)
    x = rng.standard_normal((2, 400, 2)).astype(np.float32)
    ref = np.asarray(jsinc.forward(jp, x, kernel_size=SINC_K))
    got = psinc.forward({k: t(v) for k, v in jp.items()}, t(x),
                        kernel_size=SINC_K)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        psinc.forward({k: t(v) for k, v in jp.items()},
                      t(rng.standard_normal((1, 50, 5)).astype(np.float32)),
                      kernel_size=SINC_K)

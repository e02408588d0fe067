"""Kernel K4, the beam step's bias, residual, LayerNorm and GELU chains
(``ops/step_norm.py``, ``csrc/step_norm.cu``), and its plain versions.

On the CPU: each plain version gives the bits of the torch chain that
``models/gpt.trunk_decode_step_split_anc`` ran before the chains moved
behind the wrappers (``nn.linear``'s bias add, the residual add,
``nn.layer_norm``, ``gpt._act``), in float32 and bfloat16, with and
without a GEMM output and a bias, in both GELU forms; the wrappers take the
plain route for CPU tensors and launch nothing; the whole step equals the
chain it replaces (written out here as ``_chain_step``), outputs and
caches, at the small GPT of ``tests/test_torch_decode_graph.py``, also with
int8 weights; under a mesh (identity collectives) the step equals that
chain too; the decode's K4 counter reads 0 off a card.

On the card (each test skips without one; the file imports no JAX, so run
it there with ``python -m pytest --noconftest
tests/test_torch_step_norm.py``): both entry points against their plain
versions at the four IndexTTS cells' shapes (3 and 48 rows of 1024 and
1280, and 4× that for ``bias_gelu``) in both dtypes: the residual written
over ``y`` bit for bit, LN and GELU within ``_TOL``; the wrappers raising
on what K4 does not take (a LayerNorm's parameters in another dtype than
the residual among them: no tree of the port holds such a pair).
"""
from dataclasses import replace

import pytest
import torch

from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import nn, weights
from index_tts_dubbing_tpu_torch.engine import decode
from index_tts_dubbing_tpu_torch.models import gpt
from index_tts_dubbing_tpu_torch.ops import step_norm
from index_tts_dubbing_tpu_torch.parallel import mesh as tp
from index_tts_dubbing_tpu_torch.utils.quant import quantize_gpt_int8

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=200,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
NB = 3
DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["float32", "bfloat16"]


def _rand(gen, *shape, dtype=torch.float32, scale=1.0, device="cpu"):
    return (scale * torch.randn(shape, generator=gen)).to(dtype).to(device)


def _ln_params(gen, c, dtype, device="cpu"):
    return {"g": 1.0 + _rand(gen, c, dtype=dtype, scale=0.1, device=device),
            "b": _rand(gen, c, dtype=dtype, scale=0.1, device=device)}


def _chain_add_ln(x, y, bias, p):
    """The chain as the step ran it: ``nn.linear``'s bias add, the residual
    add, ``nn.layer_norm``."""
    if y is not None:
        if bias is not None:
            y = y + bias.to(x.dtype)
        x = x + y
    return x, nn.layer_norm(p, x)


@pytest.mark.parametrize("with_y,with_bias", [(True, True), (True, False),
                                              (False, False)],
                         ids=["y_bias", "y", "ln_only"])
@pytest.mark.parametrize("param_dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_add_layer_norm_plain_is_the_chain(dtype, param_dtype, with_y,
                                           with_bias):
    gen = torch.Generator().manual_seed(3)
    r, c = 6, 96
    x = _rand(gen, r, c, dtype=dtype, scale=2.0)
    y = _rand(gen, r, c, dtype=dtype) if with_y else None
    bias = _rand(gen, c, dtype=param_dtype, scale=0.5) if with_bias else None
    p = _ln_params(gen, c, param_dtype)
    want_x, want_ln = _chain_add_ln(x, y, bias, p)
    x0 = x.clone()
    got_x, got_ln = step_norm.add_layer_norm_plain(x, y, bias, p)
    assert got_ln.dtype == dtype and got_x.dtype == dtype
    assert torch.equal(got_x, want_x) and torch.equal(got_ln, want_ln)
    assert torch.equal(x, x0)               # the residual is never written
    if with_y:
        assert got_x is y                   # the new residual over y


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("activation", ["gelu_pytorch_tanh", "gelu_new",
                                        "gelu"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_bias_gelu_plain_is_the_chain(dtype, activation, with_bias):
    gen = torch.Generator().manual_seed(5)
    cfg = pconfig.GPTConfig(**GPT_SMALL, activation=activation)
    h = _rand(gen, 6, 256, dtype=dtype, scale=3.0)
    bias = _rand(gen, 256, dtype=dtype) if with_bias else None
    want = gpt._act(cfg, h if bias is None else h + bias)
    got = step_norm.bias_gelu_plain(h, bias, activation == "gelu")
    assert got is h and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_wrappers_take_the_plain_route_on_the_cpu(dtype):
    gen = torch.Generator().manual_seed(9)
    x, y = _rand(gen, 3, 64, dtype=dtype), _rand(gen, 3, 64, dtype=dtype)
    bias, p = _rand(gen, 64, dtype=dtype), _ln_params(gen, 64, dtype)
    h, hb = _rand(gen, 3, 256, dtype=dtype), _rand(gen, 256, dtype=dtype)
    before = (step_norm.add_layer_norm.launches,
              step_norm.bias_gelu.launches, step_norm.launches())
    want = _chain_add_ln(x, y, bias, p)
    got = step_norm.add_layer_norm(x, y.clone(), bias, p)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    want_h = nn.gelu_tanh(h + hb)
    assert torch.equal(step_norm.bias_gelu(h, hb), want_h)
    assert (step_norm.add_layer_norm.launches, step_norm.bias_gelu.launches,
            step_norm.launches()) == before


def _chain_step(params, cfg, x, cache, slot, keep_p, nb, amap):
    """The beam step's trunk as it ran before K4: ln1, the qkv linear, K3's
    plain route, the projection with its bias and the residual add, ln2,
    the fc linear, the activation, the projection and the residual add."""
    for li, blk in enumerate(params["blocks"]):
        o = gpt.anc_attention(
            nn.linear(blk["attn"]["qkv"], nn.layer_norm(blk["ln1"], x)),
            cache.kp[li], cache.vp[li], cache.kg[li], cache.vg[li], slot,
            keep_p, amap, nb)
        x = x + nn.linear(blk["attn"]["proj"], o)
        f = gpt._act(cfg, nn.linear(blk["mlp"]["fc"],
                                    nn.layer_norm(blk["ln2"], x)))
        x = x + nn.linear(blk["mlp"]["proj"], f)
    return nn.layer_norm(params["ln_f"], x)


def _step_inputs(cfg, dtype, int8, seed, b=2, s0=11, g_len=16):
    gen = torch.Generator().manual_seed(seed)
    p = weights.cast_floating(weights.init_gpt(weights.Init(gen, "cpu"), cfg),
                              dtype)
    # nonzero biases and norm parameters, so each add is seen
    for blk in p["blocks"]:
        for lin in (*blk["attn"].values(), *blk["mlp"].values()):
            lin["b"] = _rand(gen, lin["b"].shape[0], dtype=dtype, scale=0.3)
        blk["ln1"] = _ln_params(gen, cfg.model_dim, dtype)
        blk["ln2"] = _ln_params(gen, cfg.model_dim, dtype)
    if int8:
        p = quantize_gpt_int8(p)
    hd = (cfg.layers, b, cfg.heads)
    cache = gpt.SplitCache(
        _rand(gen, *hd, s0, cfg.head_dim, dtype=dtype),
        _rand(gen, *hd, s0, cfg.head_dim, dtype=dtype),
        _rand(gen, *hd, NB, g_len, cfg.head_dim, dtype=dtype),
        _rand(gen, *hd, NB, g_len, cfg.head_dim, dtype=dtype))
    keep = torch.ones((b, s0), dtype=torch.bool)
    keep[1, :4] = False
    amap = torch.randint(0, NB, (b, NB, g_len), generator=gen)
    x = _rand(gen, b * NB, cfg.model_dim, dtype=dtype)
    return p, cache, keep, amap, x


def _clone_cache(cache):
    return gpt.SplitCache(*(t.clone() for t in cache))


@pytest.mark.parametrize("activation", ["gelu_pytorch_tanh", "gelu"])
@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_step_equals_the_chain_it_replaces(dtype, int8, activation):
    cfg = pconfig.GPTConfig(**GPT_SMALL, activation=activation)
    p, cache, keep, amap, x = _step_inputs(cfg, dtype, int8, seed=11)
    ref_cache = _clone_cache(cache)
    x0 = x.clone()
    for slot in (0, 7, 15):
        want = _chain_step(p, cfg, x, ref_cache, slot, keep, NB, amap)
        got = gpt.trunk_decode_step_split_anc(p, cfg, x, cache,
                                              torch.tensor(slot), keep, NB,
                                              amap)
        assert got.dtype == dtype and torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(cache, ref_cache))
    assert torch.equal(x, x0)               # the caller's input unwritten


def test_mesh_step_equals_the_chain(monkeypatch):
    """With a ``model`` axis the step runs K4's wrappers too, each
    row-parallel product reduced before its bias is added, and every qkv
    and fc input passed through ``copy_to_model``. The collectives are the
    identity here (one process standing in for each rank; a real two-rank
    mesh is ``tests/test_torch_mesh.py``), so the step equals the chain and
    makes two of each collective a layer."""
    calls = {"copy": 0, "reduce": 0}

    def collective(name):
        def fn(t):
            calls[name] += 1
            return t
        return fn

    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p, cache, keep, amap, x = _step_inputs(cfg, torch.float32, False, seed=2)
    ref_cache = _clone_cache(cache)
    want = _chain_step(p, cfg, x, ref_cache, 5, keep, NB, amap)
    monkeypatch.setattr(tp, "model_size", lambda: 2)
    monkeypatch.setattr(tp, "copy_to_model", collective("copy"))
    monkeypatch.setattr(tp, "reduce_from_model", collective("reduce"))
    got = gpt.trunk_decode_step_split_anc(p, cfg, x, cache, 5, keep, NB, amap)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref_cache))
    assert calls == {"copy": 2 * cfg.layers, "reduce": 2 * cfg.layers}


def test_counters_read_zero_off_a_card():
    """The decode's workspaces on the CPU: every step plain, no K3 or K4
    launch recorded."""
    cfg = replace(pconfig.GPTConfig(**GPT_SMALL), max_mel_tokens=12)
    gen = torch.Generator().manual_seed(0)
    p = weights.init_gpt(weights.Init(gen, "cpu"), cfg)
    b, s0 = 2, 9
    emb = torch.randn((b, s0, cfg.model_dim), generator=gen)
    keep = torch.ones((b, s0), dtype=torch.bool)
    sc = decode.SamplingConfig(do_sample=False, max_mel_tokens=12)
    ws = decode.BeamWorkspaces()
    before = step_norm.launches()
    res = decode._beam_decode(p, cfg, sc, emb, keep, None, NB, 0.0,
                              stochastic=False, workspaces=ws)
    assert res.steps > 1 and step_norm.launches() == before
    (w,) = ws._ws.values()
    assert (w.anc_attn, w.step_norm) == (0, 0)


# --- on the card -----------------------------------------------------------

# K4 against the plain version, elementwise, as |got - want| <= rtol·|want|
# + atol. The residual is bit for bit. LayerNorm: the mean and variance sum
# the same float32 values in another order (~1e-7 relative), which can move
# an output across a rounding edge of the dtype: an ulp of bfloat16 is at
# most 2^-7 of the value. GELU: the same float32 ops in the same order, an
# ulp allowed.
_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-5)}
# (rows, C, dtype): the line (one row × 3 beams) and the scene (16 × 3) of
# IndexTTS-1.5 at 1024 in bf16 and float32, IndexTTS-2's scene at 1280 in
# bf16; the small config's 64 in both
CARD_SHAPES = [(3, 1024, torch.bfloat16), (3, 1024, torch.float32),
               (48, 1024, torch.float32), (48, 1280, torch.bfloat16),
               (48, 1024, torch.bfloat16), (3, 64, torch.float32),
               (6, 64, torch.bfloat16)]
CARD_IDS = [f"{r}x{c}-{str(d)[6:]}" for r, c, d in CARD_SHAPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **_TOL[dtype])


@pytest.mark.card
@pytest.mark.parametrize("bias_dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("with_y,with_bias", [(True, True), (True, False),
                                              (False, False)],
                         ids=["y_bias", "y", "ln_only"])
@pytest.mark.parametrize("r,c,dtype", CARD_SHAPES, ids=CARD_IDS)
def test_add_layer_norm_on_the_card(cuda, r, c, dtype, with_y, with_bias,
                                    bias_dtype):
    gen = torch.Generator().manual_seed(r + c)
    x = _rand(gen, r, c, dtype=dtype, scale=3.0, device=cuda) + 0.5
    y = _rand(gen, r, c, dtype=dtype, device=cuda) if with_y else None
    bias = (_rand(gen, c, dtype=bias_dtype, scale=0.5, device=cuda)
            if with_bias else None)
    p = _ln_params(gen, c, dtype, cuda)
    y_plain = None if y is None else y.clone()
    want_x, want_ln = step_norm.add_layer_norm_plain(x, y_plain, bias, p)
    before = step_norm.add_layer_norm.launches
    got_x, got_ln = step_norm.add_layer_norm(x, y, bias, p)
    torch.cuda.synchronize()
    assert step_norm.add_layer_norm.launches == before + 1
    assert torch.equal(got_x, want_x)
    assert got_x is (x if y is None else y)
    _close(got_ln, want_ln, dtype)


@pytest.mark.card
@pytest.mark.parametrize("erf", [False, True], ids=["tanh", "erf"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("r,c,dtype", CARD_SHAPES, ids=CARD_IDS)
def test_bias_gelu_on_the_card(cuda, r, c, dtype, with_bias, erf):
    gen = torch.Generator().manual_seed(r * c)
    h = _rand(gen, r, 4 * c, dtype=dtype, scale=3.0, device=cuda)
    bias = (_rand(gen, 4 * c, dtype=dtype, device=cuda) if with_bias
            else None)
    want = step_norm.bias_gelu_plain(h.clone(), bias, erf)
    before = step_norm.bias_gelu.launches
    got = step_norm.bias_gelu(h, bias, erf)
    torch.cuda.synchronize()
    assert got is h and step_norm.bias_gelu.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.card
def test_wrappers_raise_on_what_k4_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    p = _ln_params(gen, 1020, torch.float32, cuda)
    x = _rand(gen, 3, 1020, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                    # 1020 % 8 != 0
        step_norm.add_layer_norm(x, None, None, p)
    x = _rand(gen, 3, 64, dtype=torch.float32, device=cuda)
    p = _ln_params(gen, 64, torch.float32, cuda)
    with pytest.raises(ValueError):                    # a bias without y
        step_norm.add_layer_norm(x, None, p["b"], p)
    with pytest.raises(ValueError):                    # y over x itself
        step_norm.add_layer_norm(x, x, None, p)
    with pytest.raises(TypeError):                     # g, b in another dtype
        step_norm.add_layer_norm(x.bfloat16(), None, None, p)
    with pytest.raises(ValueError):                    # not contiguous
        step_norm.add_layer_norm(x, torch.zeros_like(x).t().contiguous().t(),
                                 None, p)
    with pytest.raises(TypeError):                     # float16
        step_norm.bias_gelu(x.half(), None)
    with pytest.raises(ValueError):                    # rows of 6 values
        step_norm.bias_gelu(x[:, :6].contiguous(), None)

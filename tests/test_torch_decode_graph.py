"""The "anc" beam decode with its step replayed from a CUDA graph
(``decode.BeamWorkspaces``) against the same decode run eagerly, on the
card (each test skips without one; run them there with ``python -m pytest
tests/test_torch_decode_graph.py``).

The small GPT of the CPU tests, its weights drawn on the card, in float32
and bfloat16, at two shapes (each its own graph), every shape decoded
twice so that the second decode replays a graph captured earlier: beam
search token-identical, beam sampling token-identical from the same
generator state, which both decodes leave equal; the same with int8
weights; two decodes of one shape issued back to back, the first's
result read only after the second has run, each equal to an eager
decode; and workspaces past their byte budget dropped and captured
anew. Every step, graphed or eager, runs its attention on kernel K3 and
the work between its GEMMs on kernel K4: each captured step holds one K3
launch a layer and 3 × layers + 1 K4 launches, and neither plain chain is
reached."""
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import decode
from index_tts_dubbing_tpu_torch.ops import anc_attention as k3
from index_tts_dubbing_tpu_torch.ops import step_norm as k4
from index_tts_dubbing_tpu_torch.utils.quant import quantize_gpt_int8

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=200,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
NB = 3
# (rows, text tokens of the longest row, cap)
KEYS = [(1, 9, 40), (4, 21, 72)]
# added to the stop code's logit: some rows of beam sampling then finish
# before the cap
STOP_BIAS = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(cfg, device, dtype, int8=False):
    g = torch.Generator(device).manual_seed(0)
    p = weights.init_gpt(weights.Init(g, device), cfg)
    p["mel_head"]["b"][cfg.stop_mel_token] += STOP_BIAS
    p = weights.cast_floating(p, dtype)
    return quantize_gpt_int8(p) if int8 else p


def _prefix(cfg, p, b, n_text, seed, device):
    rng = np.random.default_rng(seed)
    texts = [rng.integers(2, 120, size=n_text - i).astype(np.int32)
             for i in range(b)]
    pre = decode.prepare_prefix_host(cfg, texts)
    conds = torch.from_numpy(rng.standard_normal(
        (b, cfg.condition_num_latent, cfg.model_dim)).astype(np.float32))
    t = lambda k: torch.as_tensor(pre[k].astype(np.int64), device=device)
    return decode.build_prefix_emb(p, cfg, conds.to(device), t("ids"),
                                   t("pos"), t("seg"), t("cond_idx"))


def _decode(cfg, p, prefix, cap, stochastic, generator, workspaces):
    sc = decode.SamplingConfig(do_sample=stochastic, max_mel_tokens=cap)
    return decode._beam_decode(p, cfg, sc, *prefix, generator, NB, 0.0,
                               stochastic=stochastic, workspaces=workspaces)


def _assert_same(a, b):
    assert torch.equal(a.codes, b.codes)
    assert torch.equal(a.lengths, b.lengths)
    assert a.steps == b.steps


def _no_plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached a plain chain")


def _graphed_against_eager(cuda, dtype, stochastic, int8=False):
    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p = _params(cfg, cuda, dtype, int8)
    ws = decode.BeamWorkspaces()
    gen_graph, gen_eager = torch.Generator(cuda), torch.Generator(cuda)
    for i, (b, n_text, cap) in enumerate(KEYS * 2):
        prefix = _prefix(cfg, p, b, n_text, i, cuda)
        gen_graph.manual_seed(i)
        gen_eager.manual_seed(i)
        graphed = _decode(cfg, p, prefix, cap, stochastic,
                          gen_graph if stochastic else None, ws)
        before = k3.anc_attention.launches, k4.launches()
        eager = _decode(cfg, p, prefix, cap, stochastic,
                        gen_eager if stochastic else None, None)
        # the eager decode: one K3 launch a layer and 3 × layers + 1 K4
        # launches at every step after step 0
        assert (k3.anc_attention.launches - before[0],
                k4.launches() - before[1]) == \
            (cfg.layers * (eager.steps - 1),
             (3 * cfg.layers + 1) * (eager.steps - 1))
        _assert_same(graphed, eager)
        assert torch.equal(gen_graph.get_state(), gen_eager.get_state())
    assert ws.captures == len(KEYS) and len(ws) == len(KEYS)
    # each captured step holds one K3 launch a layer and 3 × layers + 1 K4
    # launches
    assert [(w.anc_attn, w.step_norm) for w in ws._ws.values()] == \
        [(cfg.layers, 3 * cfg.layers + 1)] * len(KEYS)


@pytest.mark.card
@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["beam_search", "beam_sampling"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_graphed_decode_equals_eager(cuda, dtype, stochastic, monkeypatch):
    monkeypatch.setattr(k3, "anc_attention_plain", _no_plain)
    monkeypatch.setattr(k4, "add_layer_norm_plain", _no_plain)
    monkeypatch.setattr(k4, "bias_gelu_plain", _no_plain)
    _graphed_against_eager(cuda, dtype, stochastic)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_graphed_int8_decode_equals_eager(cuda, dtype):
    _graphed_against_eager(cuda, dtype, True, int8=True)


@pytest.mark.card
def test_back_to_back_decodes_of_one_key(cuda):
    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p = _params(cfg, cuda, torch.bfloat16)
    b, n_text, cap = KEYS[1]
    prefixes = [_prefix(cfg, p, b, n_text, seed, cuda) for seed in (1, 2)]
    ws = decode.BeamWorkspaces()
    gen = torch.Generator(cuda)
    _decode(cfg, p, prefixes[0], cap, True, gen, ws)       # the capture
    gen.manual_seed(5)
    graphed = [_decode(cfg, p, x, cap, True, gen, ws) for x in prefixes]
    gen.manual_seed(5)
    eager = [_decode(cfg, p, x, cap, True, gen, None) for x in prefixes]
    for g, e in zip(graphed, eager):
        _assert_same(g, e)
    assert ws.captures == 1


@pytest.mark.card
def test_workspaces_past_their_bytes_capture_anew(cuda, monkeypatch):
    """With room for one workspace, the two keys in turn each capture
    anew, the other's graph dropped, every decode equal to the eager one;
    the workspace kept counts its graph's memory pool beside its state."""
    monkeypatch.setattr(decode, "_keep_bytes", lambda dev: 1)
    cfg = pconfig.GPTConfig(**GPT_SMALL)
    p = _params(cfg, cuda, torch.float32)
    ws = decode.BeamWorkspaces()
    for i, (b, n_text, cap) in enumerate(KEYS * 2):
        prefix = _prefix(cfg, p, b, n_text, i, cuda)
        _assert_same(_decode(cfg, p, prefix, cap, False, None, ws),
                     _decode(cfg, p, prefix, cap, False, None, None))
        assert len(ws) == 1
    assert ws.captures == 2 * len(KEYS)
    (kept,) = ws._ws.values()
    state = sum(t.numel() * t.element_size()
                for t in (*kept.st.cache, *vars(kept.st).values())
                if torch.is_tensor(t))
    assert ws.nbytes > state

"""infer_fast end to end with do_sample=False, greedy (num_beams=1) and beam
search (the default num_beams=3): the port against the JAX engine with the
same weights, the same prompt and the same text, at the small config of
tests/test_engine.py with max_mel_tokens raised to 260 so that both engines
take the fused+stream route (decode caps <= 256 go to the one-program route
instead). Also: the port engine built from the JAX package's own parameter
trees, and both engines in bf16 (is_fp16=True, the main path's dtype),
module by module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.engine import decode as jdecode
from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import audio as jaudio
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from index_tts_dubbing_tpu_torch.engine.tts import IndexTTS as PortTTS
from index_tts_dubbing_tpu_torch.models import gpt as pgpt

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=260,
                 max_text_tokens=50, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)
# three sentences at max_text_tokens_per_sentence=20: 3 rows, padded to the
# batch bucket 4 with one dead row
TEXT = "Hello there friend. The quick brown fox jumps. Over the lazy dog!"
KW = dict(num_beams=1, do_sample=False, max_text_tokens_per_sentence=20)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch's CPU thread pool and XLA's contend in one process; one torch
    thread runs these small decodes many times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine, the port on its weights, and a random prompt."""
    jcfg = jconfig.EngineConfig(gpt=jgpt.GPTConfig(**GPT_SMALL),
                                bigvgan=jbigvgan.BigVGANConfig(**BV_SMALL))
    jeng = JaxTTS(config=jcfg, verbose_init=False, seed=0)
    pcfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    peng = PortTTS(config=pcfg, device="cpu", verbose_init=False,
                   params=weights.from_jax_params(jeng.params, device="cpu"))
    rng = np.random.default_rng(1)
    prompt = tmp_path_factory.mktemp("e2e") / "prompt.wav"
    jaudio.write_wav(prompt, (rng.standard_normal(24000) * 0.1
                              ).astype(np.float32), 24000)
    return jeng, peng, str(prompt)


def _assert_same_audio(jeng, peng, jout, pout):
    (jsr, jwav), (psr, pwav) = jout, pout
    np.testing.assert_array_equal(np.asarray(jeng.last_fused_res.lens),
                                  peng.last_fused_res.lens.numpy())
    assert jsr == psr == 24000
    assert pwav.dtype == jwav.dtype == np.int16
    assert pwav.shape == jwav.shape
    # float32 waveforms agree to ~1e-5 (tests/test_torch_modules.py); the
    # int16 cast of clip(wav·32767) then differs by at most 2 LSB
    diff = np.abs(pwav.astype(np.int32) - jwav.astype(np.int32))
    assert diff.max() <= 2, diff.max()


def _jax_top2_gap(jeng, prompt, step_codes, row, step):
    """The JAX engine's processed-logit gap between its best and second-best
    token for ``row`` at decode ``step`` (teacher-forced on its own codes)."""
    cfg = jeng.gpt_cfg
    params = jeng.params["gpt"]
    conds = jeng._conditioning(jeng._cond_mel(prompt))
    sents = jeng.tokenizer.split_sentences(jeng.tokenizer.tokenize(TEXT), 20)
    rows = [np.asarray(jeng.tokenizer.convert_tokens_to_ids(s), np.int32)
            for s in sents]
    rows += [np.array([2], np.int32)] * (step_codes.shape[0] - len(rows))
    pad_to = next(b for b in jeng.TEXT_BUCKETS if b >= max(r.size for r in rows))
    pre = jdecode.prepare_prefix_host(cfg, rows, pad_to=pad_to)
    emb, keep = jdecode.build_prefix_emb(
        params, cfg, conds, *(pre[k] for k in ("ids", "pos", "seg", "cond_idx")))
    b, s0 = keep.shape
    cache = jgpt.init_cache(cfg, b, s0 + step + 1, dtype=emb.dtype)
    h, cache = jgpt.trunk_prefill(params, cfg, emb, keep, cache)
    keep_all = np.concatenate([np.asarray(keep), np.ones((b, step + 1), bool)], 1)
    for j in range(1, step + 1):
        x = (params["mel_emb"]["w"][step_codes[:, j - 1]]
             + params["mel_pos"]["w"][j + 1]).astype(emb.dtype)
        kk = keep_all & (np.arange(s0 + step + 1)[None, :] <= s0 + j - 1)
        h, cache = jgpt.trunk_decode_step(params, cfg, x, cache, s0 + j - 1, kk)
    seen = np.zeros((b, cfg.number_mel_codes), bool)
    seen[:, [1, cfg.start_mel_token]] = True
    for j in range(step):
        seen[np.arange(b), step_codes[:, j]] = True
    sc = jdecode.SamplingConfig(do_sample=False, max_mel_tokens=260)
    logits = np.asarray(jdecode._process_logits(
        jgpt.mel_logits_from_hidden(params, h), jnp.asarray(seen), sc))[row]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_infer_fast_greedy_matches_jax(engines):
    jeng, peng, prompt = engines
    jout = jeng.infer_fast(prompt, TEXT, **dict(KW))
    pout = peng.infer_fast(prompt, TEXT, **dict(KW))
    assert jeng.last_fused_flavor == peng.last_fused_flavor == "fused+stream"
    jcodes = np.asarray(jeng.last_fused_res.codes)
    pcodes = peng.last_fused_res.codes.numpy()
    assert jcodes.shape == pcodes.shape == (4, 260)
    mismatch = np.argwhere(jcodes != pcodes)
    if mismatch.size:
        row, step = map(int, mismatch[np.argmin(mismatch[:, 1])])
        gap = _jax_top2_gap(jeng, prompt, jcodes, row, step)
        # a float32 near-tie is the only admissible reason to diverge
        assert gap < 1e-4, (row, step, gap)
        return
    _assert_same_audio(jeng, peng, jout, pout)


def test_infer_fast_beam_search_matches_jax(engines):
    """The default num_beams=3 with do_sample=False (beam search, the
    port's default "anc" history): codes token-exact, audio within 2 LSB."""
    jeng, peng, prompt = engines
    kw = dict(do_sample=False, max_text_tokens_per_sentence=20)
    jout = jeng.infer_fast(prompt, TEXT, **dict(kw))
    pout = peng.infer_fast(prompt, TEXT, **dict(kw))
    assert jeng.last_fused_flavor == peng.last_fused_flavor == "fused+stream"
    assert peng.last_times.decode.startswith("beam search (num_beams=3")
    jcodes = np.asarray(jeng.last_fused_res.codes)
    pcodes = peng.last_fused_res.codes.numpy()
    assert pcodes.shape == (4, 260)
    np.testing.assert_array_equal(pcodes, jcodes)
    _assert_same_audio(jeng, peng, jout, pout)


def test_requests_outside_the_slice_raise():
    """The unported beam history strategies and the mesh name their later
    slice instead of running (int8, continuous batching and the v1.0
    conditioning run now: tests/test_torch_quant.py,
    test_torch_continuous.py, test_torch_legacy_cond.py)."""
    pcfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**GPT_SMALL),
                                bigvgan=pconfig.BigVGANConfig(**BV_SMALL))
    eng = PortTTS(config=pcfg, device="cpu", verbose_init=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pdecode._beam_decode(eng.params["gpt"], pcfg.gpt,
                             pdecode.SamplingConfig(), torch.zeros(1, 3, 64),
                             torch.ones(1, 3, dtype=torch.bool), None, 3, 0.0,
                             stochastic=False, reorder="split")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 14"):
        PortTTS(config=pcfg, device="cpu", mesh=object())


def _assert_same_tree(a, b, path="params"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("stacked", [True, False])
def test_params_from_jax_numpy_tree(engines, stacked):
    """IndexTTS(params=) takes the JAX package's numpy tree, with the GPT
    trunk stacked (as ``init``/``load_params`` give it) or as a list of
    blocks, and holds the same tensors as the engine built from the port's
    own tree of the same weights."""
    jeng, peng, _ = engines
    tree = jax.tree.map(np.asarray, jeng.params)
    if not stacked:
        blocks = tree["gpt"]["blocks"]
        n = jax.tree.leaves(blocks)[0].shape[0]
        tree["gpt"] = dict(tree["gpt"], blocks=[
            jax.tree.map(lambda a, i=i: a[i], blocks) for i in range(n)])
    eng = PortTTS(config=peng.cfg, device="cpu", verbose_init=False,
                  params=tree)
    _assert_same_tree(eng.params, peng.params)


def test_bf16_engines_agree_module_by_module(engines):
    """is_fp16=True in both packages on the same weights: the JAX engine's
    bf16 tree (ml_dtypes leaves, stacked trunk) is the port's ``params``.
    Tokens may split at bf16 near-ties of random-weight logits, so the
    modules are held, each on shared inputs: conditioning, prefix embedding,
    teacher-forced mel logits over prefill and 7 decode steps, and the
    vocoder on shared bf16 latents."""
    jeng, peng, prompt = engines
    jbf = JaxTTS(config=jeng.cfg, verbose_init=False, is_fp16=True,
                 params=jeng.params)
    pbf = PortTTS(config=peng.cfg, device="cpu", verbose_init=False,
                  is_fp16=True, params=jbf.params)
    jp, pp, cfg = jbf.params["gpt"], pbf.params["gpt"], pbf.gpt_cfg
    assert pp["mel_emb"]["w"].dtype == torch.bfloat16

    jc = np.asarray(jbf._conditioning(jbf._cond_mel(prompt)))
    pc = pbf._conditioning(pbf._cond_mel(prompt))
    # float32 in both (the conditioning upcasts): < 2e-6 observed
    np.testing.assert_allclose(pc.numpy(), jc, atol=1e-5)

    rows = pbf.sentence_rows(TEXT, 20)
    pre = jdecode.prepare_prefix_host(jbf.gpt_cfg, rows, pad_to=16)
    args = [pre[k] for k in ("ids", "pos", "seg", "cond_idx")]
    jemb, jkeep = jdecode.build_prefix_emb(jp, jbf.gpt_cfg, jc, *args)
    emb, keep = pdecode.build_prefix_emb(
        pp, cfg, torch.from_numpy(np.array(jc)),
        *(torch.from_numpy(a).long() for a in args))
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(),
                                  np.asarray(jemb, np.float32))

    b, s0 = keep.shape
    steps = 8
    codes = np.random.default_rng(2).integers(0, cfg.start_mel_token,
                                              size=(steps, b))
    jcache = jgpt.init_cache(jbf.gpt_cfg, b, s0 + steps, dtype=jemb.dtype)
    jh, jcache = jgpt.trunk_prefill(jp, jbf.gpt_cfg, jemb, jkeep, jcache)
    cache = pgpt.init_cache(cfg, b, s0 + steps, emb.dtype, "cpu")
    h = pgpt.trunk_prefill(pp, cfg, emb, keep, cache)
    jkeep_all = np.concatenate([np.asarray(jkeep), np.ones((b, steps), bool)], 1)
    keep_all = torch.cat([keep, torch.zeros((b, steps), dtype=torch.bool)], 1)
    for j in range(steps):
        if j:
            slot = s0 + j - 1
            jx = jp["mel_emb"]["w"][codes[j - 1]] + jp["mel_pos"]["w"][j + 1]
            kk = jkeep_all & (np.arange(s0 + steps)[None, :] <= slot)
            jh, jcache = jgpt.trunk_decode_step(jp, jbf.gpt_cfg, jx, jcache,
                                                slot, kk)
            keep_all[:, slot] = True
            x = (pp["mel_emb"]["w"][torch.from_numpy(codes[j - 1])]
                 + pp["mel_pos"]["w"][j + 1])
            h = pgpt.trunk_decode_step(pp, cfg, x, cache, slot, keep_all)
        jl = np.asarray(jgpt.mel_logits_from_hidden(jp, jh), np.float32)
        pl_ = pgpt.mel_logits_from_hidden(pp, h).float().numpy()
        # bf16 logits, rounded at different places in the two frameworks:
        # 0.0195 observed at |logit| <= 2.75, where a bf16 ulp is 2^-6;
        # 0.04 is 2.5 of those ulps
        assert np.abs(jl).max() < 4.0
        np.testing.assert_allclose(pl_, jl, atol=0.04, err_msg=f"step {j}")

    lat = (np.random.default_rng(3).standard_normal((1, 150, 64)) * 0.3)
    lat_bf = torch.from_numpy(lat.astype(np.float32)).to(torch.bfloat16)
    mel = pbf._cond_mel(prompt).transpose(1, 2)
    spk = pbf.vocoder.speaker_embedding(mel)
    jspk = jbf.vocoder.speaker_embedding(jnp.asarray(mel.numpy()))
    np.testing.assert_allclose(spk.numpy(), np.asarray(jspk), atol=1e-5)
    got = pbf.vocoder.stream_device(lat_bf, np.array([150]), spk=spk)
    ref = jbf.vocoder.stream_device(
        jnp.asarray(lat_bf.float().numpy(), jnp.bfloat16), np.array([150]),
        spk=jspk)
    # the float32 speaker conditioning promotes both vocoders to float32
    # after conv_pre, so only conv_pre runs in bf16: < 2e-5 observed on
    # |wav| <= 0.37
    np.testing.assert_allclose(got, ref, atol=1e-4)

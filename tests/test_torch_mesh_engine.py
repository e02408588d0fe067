"""The port's engine on a mesh: ``IndexTTS(mesh=make_mesh(2, 2))`` in four
gloo worker processes on the CPU (tests/test_torch_mesh_worker.py),
mirroring tests/test_parallel.py's engine test.

Against the JAX engine without a mesh (float32, the small config of
tests/test_torch_engine.py, beam search at cap 16): ``infer`` within 2 LSB
and ``infer_batch(continuous=True)`` token-exact (every rank runs every
request, tensor-parallel over ``model``). Against the port's one-process
engine on the staged route with the same seed: ``infer_fast``,
``infer_batch`` and ``infer_fast`` with the reference's default decode
(beam sampling) within 2 LSB. Every rank's wav is rank 0's: the
collectives leave the model ranks bit-identical and each data group
gathers the codes of the whole batch."""
import json

import jax
import numpy as np
import pytest

from index_tts_dubbing_tpu.engine.tts import IndexTTS as JaxTTS
from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import audio as jaudio
from index_tts_dubbing_tpu.utils import config as jconfig
from tests.test_torch_mesh_worker import run_ranks

GPT_SMALL = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=260,
                 max_text_tokens=130, number_text_tokens=120,
                 cond_output_size=32, cond_linear_units=64,
                 cond_attention_heads=4, cond_num_blocks=2)
BV_SMALL = dict(gpt_dim=64, upsample_initial_channel=128)
TEXTS = ["Hello there friend. The quick brown fox jumps.",
         "Over the lazy dog!"]
KW = dict(do_sample=False, max_mel_tokens=16, max_text_tokens_per_sentence=20)
I16_TOL = 2


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_engine")
    jcfg = jconfig.EngineConfig(gpt=jgpt.GPTConfig(**GPT_SMALL),
                                bigvgan=jbigvgan.BigVGANConfig(**BV_SMALL))
    jeng = JaxTTS(config=jcfg, verbose_init=False, seed=0)
    rng = np.random.default_rng(1)
    prompt = str(tmp / "prompt.wav")
    jaudio.write_wav(prompt, (rng.standard_normal(24000) * 0.1
                              ).astype(np.float32), 24000)
    ref = {"infer": jeng.infer(prompt, TEXTS[0], None, **KW)[1]}
    rec = []
    inner = jeng._decode_continuous

    def record(*a, **k):
        codes, lens = inner(*a, **k)
        rec.append((np.asarray(codes), np.asarray(lens)))
        return codes, lens

    jeng._decode_continuous = record
    ref["cont"] = [w for _, w in jeng.infer_batch(
        prompt, TEXTS, continuous=True, cb_slots=2, num_beams=1, **KW)]
    ref["cont_codes"], ref["cont_lens"] = rec[0]
    inputs = {"params": jax.tree.map(np.asarray, jeng.params),
              "cfg": np.asarray(json.dumps(dict(
                  gpt=GPT_SMALL, bigvgan=BV_SMALL, prompt=prompt,
                  texts=TEXTS))),
              "steps": KW["max_mel_tokens"]}
    out, logs = run_ranks("engine", tmp, inputs, data=2, model=2,
                          timeout=400)
    return ref, out, logs


def assert_i16_close(pwav, jwav):
    assert pwav.dtype == jwav.dtype == np.int16
    assert pwav.shape == jwav.shape and pwav.size
    diff = np.abs(pwav.astype(np.int32) - jwav.astype(np.int32)).max()
    assert diff <= I16_TOL, diff


def test_infer_matches_jax(served):
    ref, out, _ = served
    assert_i16_close(out["mesh"]["infer"], ref["infer"])


def test_infer_batch_continuous_token_exact(served):
    ref, out, _ = served
    np.testing.assert_array_equal(out["cont"]["lens"], ref["cont_lens"])
    np.testing.assert_array_equal(out["cont"]["codes"], ref["cont_codes"])
    for i, jwav in enumerate(ref["cont"]):
        assert_i16_close(out["cont"][f"wav{i}"], jwav)


@pytest.mark.parametrize("call", ["infer_fast", "batch0", "batch1", "sample"])
def test_mesh_matches_one_process(served, call):
    """The staged route on the mesh (the fused route is never taken there)
    equals one process's, beam search and beam sampling alike."""
    _, out, _ = served
    assert str(out["mesh"]["fast_path"]) == "staged"
    assert_i16_close(out["mesh"][call], out["single"][call])


def test_every_rank_returns_the_same_wav(served):
    _, _, logs = served
    digests = {line for log in logs for line in log.splitlines()
               if line.startswith("WAV_DIGEST")}
    assert len(digests) == 1, digests

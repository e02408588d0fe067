"""The port's configuration, parameter trees and import isolation, held
against the JAX package."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from index_tts_dubbing_tpu.models import bigvgan as jbigvgan
from index_tts_dubbing_tpu.models import gpt as jgpt
from index_tts_dubbing_tpu.utils import config as jconfig
from index_tts_dubbing_tpu_torch import config as pconfig
from index_tts_dubbing_tpu_torch import weights

REPO = Path(__file__).resolve().parent.parent


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_equal_jax():
    pairs = [(pconfig.GPTConfig, jgpt.GPTConfig),
             (pconfig.BigVGANConfig, jbigvgan.BigVGANConfig),
             (pconfig.MelConfig, jconfig.MelConfig)]
    for port_cls, jax_cls in pairs:
        assert _fields(port_cls) == _fields(jax_cls), port_cls.__name__
    assert ([f.name for f in dataclasses.fields(pconfig.EngineConfig)]
            == [f.name for f in dataclasses.fields(jconfig.EngineConfig)])
    assert (dataclasses.asdict(pconfig.EngineConfig())
            == dataclasses.asdict(jconfig.EngineConfig()))
    small = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60)
    p, j = pconfig.GPTConfig(**small), jgpt.GPTConfig(**small)
    assert (p.max_mel_seq, p.max_text_seq, p.head_dim) == (
        j.max_mel_seq, j.max_text_seq, j.head_dim)
    pb, jb = pconfig.BigVGANConfig(), jbigvgan.BigVGANConfig()
    assert [pb.stage_channels(i) for i in range(pb.num_upsamples)] == [
        jb.stage_channels(i) for i in range(jb.num_upsamples)]


def test_load_config_reads_yaml(tmp_path):
    yml = tmp_path / "config.yaml"
    yml.write_text(
        "version: 1.5\n"
        "dataset:\n  bpe_model: my_bpe.model\n  mel:\n    n_mels: 80\n"
        "    hop_length: 200\n"
        "gpt:\n  model_dim: 256\n  layers: 3\n  heads: 8\n"
        "  activation_function: gelu_new\n"
        "  condition_module:\n    output_size: 128\n    num_blocks: 2\n"
        "bigvgan:\n  upsample_initial_channel: 256\n"
        "  upsample_rates: [4, 4, 2]\n  upsample_kernel_sizes: [8, 8, 4]\n"
        "  resblock_dilation_sizes: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]\n"
        "  snake_logscale: false\n"
        "  cond_d_vector_in_each_upsampling_layer: false\n"
        "gpt_checkpoint: g.pth\n")
    got = pconfig.load_config(yml)
    assert got.gpt.model_dim == 256 and got.mel.n_mels == 80
    assert got.bigvgan.upsample_rates == (4, 4, 2)
    assert got.bigvgan.cond_in_each_up_layer is False
    assert dataclasses.asdict(got) == dataclasses.asdict(jconfig.load_config(yml))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(np.shape(tree))}


def test_init_tree_matches_jax_init_and_bridge():
    """The port's own init builds the JAX init's tree and shapes, and
    from_jax_params unstacks the GPT trunk into that same tree."""
    gcfg = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=60,
                max_text_tokens=50, number_text_tokens=120,
                cond_output_size=32, cond_linear_units=64,
                cond_attention_heads=4, cond_num_blocks=2)
    bcfg = dict(gpt_dim=64, upsample_initial_channel=128)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jparams = {"gpt": jgpt.init(k1, jgpt.GPTConfig(**gcfg)),
               "bigvgan": jbigvgan.init(k2, jbigvgan.BigVGANConfig(**bcfg))}
    bridged = weights.from_jax_params(jparams, device="cpu")
    cfg = pconfig.EngineConfig(gpt=pconfig.GPTConfig(**gcfg),
                               bigvgan=pconfig.BigVGANConfig(**bcfg))
    own = weights.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(own) == _shapes(bridged)
    assert isinstance(bridged["gpt"]["blocks"], list)
    np.testing.assert_array_equal(
        bridged["gpt"]["blocks"][1]["attn"]["qkv"]["w"].numpy(),
        np.asarray(jparams["gpt"]["blocks"]["attn"]["qkv"]["w"])[1])
    bf = weights.cast_floating(bridged, torch.bfloat16)
    assert bf["bigvgan"]["conv_pre"]["w"].dtype == torch.bfloat16


def test_port_imports_no_jax(tmp_path):
    """Importing every port module and running chip_smoke.py --help leaves
    jax and the JAX package out of sys.modules."""
    code = (
        "import pkgutil, runpy, sys, importlib\n"
        "import index_tts_dubbing_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.argv = ['chip_smoke.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'index_tts_dubbing_tpu'\n"
        "             or m.startswith('index_tts_dubbing_tpu.'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout[-2000:]

"""The conformer's five other input layers and ECAPA's classifier head
against the JAX package's (which its own tests hold against the
reference's classes), in float32 on the same numpy weights from a seed; and
``make_mesh``, which runs on the card unless the caller asks for the CPU."""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu.models import conformer as jconformer
from index_tts_dubbing_tpu.models import ecapa as jecapa
from index_tts_dubbing_tpu_torch import weights
from index_tts_dubbing_tpu_torch.models import conformer as pconformer
from index_tts_dubbing_tpu_torch.models import ecapa as pecapa
from index_tts_dubbing_tpu_torch.parallel import mesh as pmesh

# tests/test_conditioning.py's shapes
IDIM, ODIM, T = 40, 32, 37
# float32 convs and products in another summation order (< 2e-6 seen)
TOL = 2e-5
# the conv stacks: (key, kernel, stride) per conv, then the mask's cut
LAYERS = {
    "conv2d_subsample3": ([("conv", 5, 3)], lambda m: m[:, :-2:3]),
    "conv2d_subsample4": ([("conv0", 3, 2), ("conv1", 3, 2)],
                          lambda m: m[:, 2::2][:, 2::2]),
    "conv2d_subsample6": ([("conv0", 3, 2), ("conv1", 5, 3)],
                          lambda m: m[:, 2::2][:, 4::3]),
    "conv2d_subsample8": ([("conv0", 3, 2), ("conv1", 3, 2), ("conv2", 3, 2)],
                          lambda m: m[:, 2::2][:, 2::2][:, 2::2]),
}


def _w(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(tree):
    return weights.from_jax_params(tree, device="cpu")


@pytest.mark.parametrize("name", ["linear_no_subsample", *LAYERS])
def test_conformer_input_layers_match_jax(rng, name):
    """Each input layer's output within TOL of JAX's and its mask equal, on
    a batch whose second row is padded."""
    x = rng.standard_normal((2, T, IDIM)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[1, 29:] = False
    if name == "linear_no_subsample":
        p = {"out": {"w": _w(rng, IDIM, ODIM), "b": _w(rng, ODIM)},
             "ln": {"g": 1.0 + _w(rng, ODIM), "b": _w(rng, ODIM)}}
        cut = lambda m: m
    else:
        convs, cut = LAYERS[name]
        p, cin, f = {}, 1, IDIM
        for key, k, s in convs:
            p[key] = {"w": _w(rng, k, k, cin, ODIM), "b": _w(rng, ODIM)}
            cin, f = ODIM, (f - k) // s + 1
        p["out"] = {"w": _w(rng, ODIM * f, ODIM, scale=0.05),
                    "b": _w(rng, ODIM)}
    want, wmask = getattr(jconformer, name)(p, x, mask)
    got, gmask = getattr(pconformer, name)(_t(p), torch.from_numpy(x),
                                           torch.from_numpy(mask))
    assert got.shape == want.shape and got.shape[-1] == ODIM
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gmask.numpy(), cut(mask))


@pytest.mark.parametrize("lin_blocks", [0, 1])
def test_classifier_matches_jax(rng, lin_blocks):
    """classifier_forward on JAX classifier_init's tree (512 → 40), its
    batch norms given random statistics: within TOL, cosines in [-1, 1]."""
    tree = jecapa.classifier_init(jax.random.PRNGKey(lin_blocks), 512,
                                  lin_blocks, 192, 40)
    for blk in tree["blocks"]:
        d = blk["bn"]["g"].shape[0]
        blk["bn"] = {"g": 1.0 + _w(rng, d), "b": _w(rng, d),
                     "mean": _w(rng, d), "var": 0.5 + np.abs(_w(rng, d))}
    x = rng.standard_normal((3, 1, 512)).astype(np.float32)
    want = np.asarray(jecapa.classifier_forward(tree, x))
    got = pecapa.classifier_forward(_t(tree), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 1, 40)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(got).max() <= 1.0 + 1e-6


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("lin_blocks", [0, 1, 2])
def test_classifier_init_matches_jax_tree(lin_blocks):
    """init_ecapa_classifier's tree has classifier_init's keys and shapes,
    its linear weights inside JAX's Glorot-uniform limits and reaching
    them, its biases and batch-norm statistics JAX's constants."""
    args = (512, lin_blocks, 192, 1211)
    want = jecapa.classifier_init(jax.random.PRNGKey(0), *args)
    got = weights.init_ecapa_classifier(
        weights.Init(torch.Generator().manual_seed(0), "cpu"), *args)
    assert _shapes(got) == _shapes(want)
    d = 512
    for gb, wb in zip(got["blocks"], want["blocks"]):
        lim = np.sqrt(6.0 / (d + 192))
        w = gb["lin"]["w"].abs().max().item()
        assert 0.99 * lim < w <= lim
        np.testing.assert_array_equal(gb["lin"]["b"].numpy(), wb["lin"]["b"])
        for key, v in gb["bn"].items():
            np.testing.assert_array_equal(v.numpy(), wb["bn"][key])
        d = 192
    lim = np.sqrt(6.0 / (1211 + d))
    assert 0.99 * lim < got["weight"].abs().max().item() <= lim


def test_make_mesh_needs_a_card_or_the_cpu_asked_for(tmp_path):
    """With no card visible, make_mesh raises unless the caller passes
    devices="cpu" (a one-rank gloo group)."""
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        backend = pmesh.init_distributed(f"file://{tmp_path / 'store'}", 1, 0)
        try:
            assert backend == "gloo"
            with pytest.raises(RuntimeError, match='devices="cpu"'):
                pmesh.make_mesh(1, 1)
            mesh = pmesh.make_mesh(1, 1, devices="cpu")
            assert mesh.device_type == "cpu"
            assert pmesh.axis_size(mesh, "data") == 1
            assert pmesh.axis_size(mesh, "model") == 1
        finally:
            torch.distributed.destroy_process_group()

"""The port's gen-cache permute functions (ops/permute.py) held against the
JAX package's Pallas kernels (ops/pallas_permute.py) on the CPU, bit for
bit, on the same numpy inputs: ``copy_on_fork`` in its ``interpret=True``
mode, as tests/test_pallas_permute.py runs it, and the four gathers inside
``force_tpu_interpret_mode()``. On the CPU the public wrappers take the
plain versions and launch nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from index_tts_dubbing_tpu.ops import pallas_permute as pp
from index_tts_dubbing_tpu_torch.ops import permute as port

L, BN, H, G, D = 2, 6, 4, 32, 64

CP = {
    "none": [-1, -1, -1, -1, -1, -1],
    "one_per_group": [-1, -1, 0, -1, 3, -1],      # nb = 3: row 2 <- 0, 4 <- 3
    "max": [-1, 0, 0, 5, -1, -1],                 # all forks of each group
}
SRC = {
    "identity": [0, 1, 2, 3, 4, 5],
    "reversal": [5, 4, 3, 2, 1, 0],
    "forks": [0, 0, 0, 5, 5, 3],
}


@pytest.fixture(scope="module")
def caches():
    rng = np.random.default_rng(0)
    kg = rng.standard_normal((L, BN, H, G, D)).astype(np.float32)
    vg = rng.standard_normal((L, BN, H, G, D)).astype(np.float32)
    return kg, vg


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.mark.parametrize("gb", [8, 64])
@pytest.mark.parametrize("bound", [-1, 0, 7, 8, 15, 31])
@pytest.mark.parametrize("pattern", sorted(CP))
def test_copy_on_fork_plain_matches_pallas(caches, pattern, bound, gb):
    kg, vg = caches
    cp = np.array(CP[pattern], np.int32)
    jk, jv = pp.copy_on_fork(jnp.asarray(kg), jnp.asarray(vg), jnp.asarray(cp),
                             jnp.int32(bound), gb=gb, interpret=True)
    k, v = _t(kg), _t(vg)
    pk, pv = port.copy_on_fork_plain(k, v, _t(cp), bound, gb=gb)
    assert pk is k and pv is v                      # in place
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_copy_on_fork_without_aligned_block_copies_whole_rows(caches):
    """G = 5 has no block size with (gb·D) % 128 == 0: the Pallas wrapper
    gathers whole rows whatever the bound, and so does the port."""
    kg, vg = (np.ascontiguousarray(a[:, :, :, :5]) for a in caches)
    cp = np.array(CP["max"], np.int32)
    assert port.fork_block(5, D) == 0
    jk, jv = pp.copy_on_fork(jnp.asarray(kg), jnp.asarray(vg), jnp.asarray(cp),
                             jnp.int32(2))
    pk, pv = port.copy_on_fork_plain(_t(kg), _t(vg), _t(cp), 2)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_fork_slots_at_full_width():
    """The decode's gen cache at full width: G = 600, D = 64 gives gb = 60;
    a forked row copies whole 60-slot blocks up to the bound."""
    assert port.fork_block(600, 64) == 60
    assert [port.fork_slots(600, 64, b) for b in (-1, 0, 59, 60, 299, 599)] \
        == [0, 60, 60, 120, 300, 600]


@pytest.mark.parametrize("src", sorted(SRC))
@pytest.mark.parametrize("name", ["permute_gen_cache",
                                  "permute_gen_cache_pipelined"])
def test_gather_plain_matches_pallas(caches, name, src):
    kg, vg = caches
    idx = np.array(SRC[src], np.int32)
    with pltpu.force_tpu_interpret_mode():
        jk, jv = getattr(pp, name)(jnp.asarray(kg), jnp.asarray(vg),
                                   jnp.asarray(idx))
    pk, pv = getattr(port, name + "_plain")(_t(kg), _t(vg), _t(idx))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("bound", [-1, 0, 7, 8, 20, 31])
@pytest.mark.parametrize("src", ["reversal", "forks"])
@pytest.mark.parametrize("name", ["permute_gen_cache_burst",
                                  "permute_gen_cache_bounded"])
def test_bounded_gather_plain_matches_pallas(caches, name, src, bound):
    kg, vg = caches
    idx = np.array(SRC[src], np.int32)
    with pltpu.force_tpu_interpret_mode():
        jk, jv = getattr(pp, name)(jnp.asarray(kg), jnp.asarray(vg),
                                   jnp.asarray(idx), jnp.int32(bound), gb=8)
    pk, pv = getattr(port, name + "_plain")(_t(kg), _t(vg), _t(idx), bound,
                                            gb=8)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_bounded_gather_masks_a_ragged_last_block():
    """G = 600 with gb = 64 gives 10 blocks, the last running past G: the
    port copies or zeroes only slots < G, slot by slot."""
    kg = torch.arange(1, 2 * 3 * 600 + 1, dtype=torch.float32).reshape(
        1, 2, 3, 600, 1).expand(1, 2, 3, 600, 2).contiguous()
    src = torch.tensor([1, 0], dtype=torch.int32)
    for bound, n in ((576, 600), (575, 576), (63, 64), (-1, 0)):
        k2, _ = port.permute_gen_cache_bounded_plain(kg, kg, src, bound)
        np.testing.assert_array_equal(k2[:, :, :, :n].numpy(),
                                      kg[:, [1, 0], :, :n].numpy())
        assert not k2[:, :, :, n:].any()


def test_wrappers_take_the_plain_versions_on_cpu(caches):
    kg, vg = caches
    for fn in (port.copy_on_fork,) + port.GATHERS:
        fn.launches = 0
    cp = _t(CP["max"], np.int32)
    src = _t(SRC["forks"], np.int32)
    got = port.copy_on_fork(_t(kg), _t(vg), cp, 9)
    want = port.copy_on_fork_plain(_t(kg), _t(vg), cp, 9)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for fn in port.GATHERS:
        args = (src,) if "burst" not in fn.__name__ and \
            "bounded" not in fn.__name__ else (src, 9)
        got = fn(_t(kg), _t(vg), *args)
        want = getattr(port, fn.__name__ + "_plain")(_t(kg), _t(vg), *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [fn.launches for fn in (port.copy_on_fork,) + port.GATHERS] \
        == [0] * 5

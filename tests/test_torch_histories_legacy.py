"""The legacy single-buffer beam histories ("full", "gen", "flat",
"flatfull", "mm", "blocked" and the diagnostic "none") held against the
JAX package's same strategy on the CPU, as tests/test_torch_histories.py
holds the ancestry and split families (its setup, modes and tolerances)."""
import numpy as np
import pytest
import torch

from index_tts_dubbing_tpu_torch.engine import decode as pdecode
from index_tts_dubbing_tpu_torch.ops import permute
from tests.test_torch_histories import (ANC_SPLIT, MODES, _one_torch_thread,  # noqa: F401
                                        assert_same, run_both, run_port,
                                        setups)

LEGACY = ("full", "gen", "flat", "flatfull", "mm", "blocked", "none")


def test_the_two_files_cover_every_strategy():
    assert sorted(ANC_SPLIT + LEGACY) == sorted(pdecode.BEAM_REORDERS)
    assert len(pdecode.BEAM_REORDERS) == 17


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("reorder", LEGACY)
def test_history_matches_jax(setups, monkeypatch, reorder, mode):  # noqa: F811
    stochastic, bias = MODES[mode]
    jres, pres = run_both(setups[bias], reorder, stochastic, monkeypatch)
    assert_same(jres, pres, f"{reorder} {mode}")


def test_legacy_histories_equal_full_and_launch_nothing(setups, monkeypatch):  # noqa: F811
    """Every legacy strategy but "none" gives "full"'s tokens in every mode,
    and none of them calls copy_on_fork."""
    def no_fork(*args, **kwargs):
        raise AssertionError("a legacy history called copy_on_fork")

    monkeypatch.setattr(permute, "copy_on_fork", no_fork)
    for mode, (stochastic, bias) in MODES.items():
        full = run_port(setups[bias], "full", stochastic, monkeypatch)
        for reorder in LEGACY[1:-1]:
            got = run_port(setups[bias], reorder, stochastic, monkeypatch)
            assert torch.equal(got.codes, full.codes), (reorder, mode)
            np.testing.assert_array_equal(got.lengths, full.lengths)

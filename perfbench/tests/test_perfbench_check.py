"""The check's reading of beam sampling: the kept set it rebuilds is the
one the program's decoder samples from, and a code outside it reads its
distance below the boundary."""
import pytest
import torch

from index_tts_dubbing_tpu_torch.engine import decode as decode_mod
from perfbench import check


@pytest.mark.parametrize("top_k,top_p,scale", [(30, 0.8, 1.0), (30, 0.8, 8.0),
                                               (5, 0.5, 3.0), (1, 1.0, 1.0)])
def test_boundary_keeps_what_the_decoder_keeps(top_k, top_p, scale):
    g = torch.Generator().manual_seed(top_k)
    s = torch.log_softmax(scale * torch.randn(64, 500, generator=g), -1)
    sc = decode_mod.SamplingConfig(top_k=top_k, top_p=top_p)
    want = torch.isfinite(decode_mod._warp_scores(s, sc))
    got = s >= check.boundary(s, top_k, top_p)[:, None]
    assert torch.equal(got, want)


def test_scores_penalise_what_the_row_has_seen():
    logits = torch.zeros(4, 10)
    codes = torch.tensor([3, 5, 3, 7])
    s = check.scores(logits, codes, start_mel=8, temperature=1.0)
    logp = torch.log_softmax(logits, -1)[0, 0]
    for pos, seen in enumerate([{1, 8}, {1, 8, 3}, {1, 8, 3, 5},
                                {1, 8, 3, 5}]):
        for v in range(10):
            want = logp * check.REPETITION_PENALTY if v in seen else logp
            assert s[pos, v] == pytest.approx(float(want))


def test_served_code_outside_the_kept_set_reads_its_gap():
    s = torch.tensor([[0.0, -1.0, -2.0, -9.0]]).log_softmax(-1)
    b = check.boundary(s, 2, 1.0)
    assert float(b) == pytest.approx(float(s[0, 1]))
    assert float(b - s[0, 3]) == pytest.approx(8.0)

"""The FLOP and byte counts against hand counts and the port's records."""
import pytest

from perfbench import roofline

B = 4
K2_SHAPES = [(c, t, k) for c, t in ((96, 36864), (48, 73728), (24, 147456))
             for k in (3, 7, 11)]
FULL_BIGVGAN = dict(gpt_dim=1024, upsample_initial_channel=1536,
                    upsample_rates=[4, 4, 4, 4, 2, 2],
                    upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
                    resblock_kernel_sizes=[3, 7, 11])
GPT = dict(model_dim=1024, layers=20, number_mel_codes=8194,
           condition_num_latent=32)


def test_k2_window_batch_bound_matches_the_records():
    """PERF.md's K2 bound: 9.607 ms per float32 window batch of 4 at
    67 TFLOP/s (operations bound)."""
    total = sum(roofline.k2_bound_fp32_s(B, c, t, k) for c, t, k in K2_SHAPES)
    assert total * 1e3 == pytest.approx(9.607, abs=1.5e-3)


@pytest.mark.parametrize("c,t,k", K2_SHAPES)
def test_k2_counts_by_hand(c, t, k):
    assert roofline.k2_conv_ops(B, c, t, k) == 6 * (2 * c * c * k) * B * t
    assert roofline.k2_act_ops(B, c, t) == 6 * 58 * B * c * t
    io = 2 * B * c * t * 4
    w = 6 * k * c * c * 4 + 6 * c * 4 + 12 * c * 4
    assert roofline.k2_bytes(B, c, t, k, "float32") == io + w
    w_bf16 = w - 6 * k * c * c * 2      # w1 and w2 in two bytes a weight
    assert roofline.k2_bytes(B, c, t, k, "bfloat16") == io // 2 + w_bf16


def test_k2_tensor_core_bound_is_the_larger_of_two():
    c, t, k = 96, 36864, 11
    ops = roofline.k2_conv_ops(B, c, t, k)
    assert roofline.k2_bound_s(B, c, t, k, "float32") == pytest.approx(
        ops / 495e12)
    assert roofline.k2_bound_s(B, c, t, k, "bfloat16") == pytest.approx(
        ops / 989e12)
    # the 9 float32 launches of a window batch: their convs at the TF32
    # peak, 1.22 ms (the activations are not tensor-core work)
    tf32 = sum(roofline.k2_bound_s(B, *s, "float32") for s in K2_SHAPES)
    assert tf32 * 1e3 == pytest.approx(1.2198, abs=1e-3)


def test_bigvgan_ops_per_frame_by_hand():
    ops = 2 * 1024 * 1536 * 7
    ch, samples = 1536, 1
    for u, k in zip([4, 4, 4, 4, 2, 2], [8, 8, 4, 4, 4, 4]):
        c = ch // 2
        ops += 2 * ch * c * k * samples
        samples *= u
        ops += 2 * 6 * c * c * (3 + 7 + 11) * samples
        ch = c
    ops += 2 * 24 * 7 * 1024
    assert roofline.bigvgan_ops_per_frame(FULL_BIGVGAN) == ops
    assert 2.8e9 < ops < 3.0e9


def test_gpt_counts_by_hand():
    d, n = 1024, 20
    assert roofline.gpt_block_ops(d, 1) == 2 * 12 * d * d
    # one cached step at context 100: blocks + attention + the mel head
    assert roofline.gpt_decode_ops(GPT, 99, 2) == (
        n * (24 * d * d + 4 * d * 100) + 2 * d * 8194)
    s = 75
    assert roofline.gpt_prefill_ops(GPT, s) == (
        n * (24 * d * d * s + 4 * d * s * (s + 1) / 2) + 2 * d * 8194)
    # a beam-3 row decodes about 1.6 GFLOP a frame (3 x 0.53)
    per = roofline.gpt_decode_ops(GPT, 70, 165) / 164
    assert 0.52e9 < per < 0.55e9


def test_model_flops_sums_its_parts():
    cfg = {"gpt": GPT, "bigvgan": FULL_BIGVGAN}
    got = roofline.model_flops(cfg, [20], 3, 100, [100])
    s0 = 32 + 20 + 3
    want = (roofline.gpt_prefill_ops(GPT, s0)
            + 3 * roofline.gpt_decode_ops(GPT, s0, 100)
            + roofline.gpt_prefill_ops(GPT, 32 + 22 + 102) - 2 * 1024 * 8194
            + 100 * roofline.bigvgan_ops_per_frame(FULL_BIGVGAN))
    assert got == pytest.approx(want)

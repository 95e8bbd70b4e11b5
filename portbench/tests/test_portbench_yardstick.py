"""The yardstick's counts against hand counts."""
import pytest

from portbench.yardstick import costs, peaks


def test_peaks_are_the_h100_data_sheet():
    assert (peaks.PEAK_FLOPS_BF16, peaks.PEAK_FLOPS_F32, peaks.HBM_BW) == \
        (989e12, 67e12, 3.35e12)


def test_flash_counts_valid_pairs_only():
    # 3 queries after 2 cached positions: keys 3, 4, 5 -> 12 pairs
    assert costs.causal_pairs(2, 3) == 12
    b, f = costs.flash_prefill_cost(H=4, Hkv=2, Dh=8, pos0=2, n=3)
    assert f == 4 * 4 * 8 * 12
    # q and o: 3 x 4 x 8 bf16 each; k and v: 5 x 2 x 8 bf16 each
    assert b == 2 * 3 * 4 * 8 * 2 + 2 * 5 * 2 * 8 * 2


def test_paged_counts_live_pages_and_skips_padding():
    # rows of 3 and 17 stored tokens (pages of 8), one padded row
    b, f = costs.paged_decode_cost(H=4, Hkv=2, Dh=8, page_size=8,
                                   lengths=[3, 17, -1])
    pages = 1 + 3
    assert b == (2 * pages * 8 * 2 * 8 * 4     # f32 K and V pages
                 + 2 * 2 * 4 * 8 * 2           # bf16 q and o, 2 live rows
                 + 2 * 2 * 2 * 8 * 4)          # the appended K and V
    assert f == 4 * 4 * 8 * (4 + 18)
    assert costs.kernel_time_bound(3.35e12, 0.0) == pytest.approx(1.0)
    assert costs.kernel_time_bound(0.0, 989e12) == pytest.approx(1.0)


DENSE = {"num_layers": 2, "d_model": 16, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 4, "d_ff": 32, "vocab_size": 300}
MOE = dict(DENSE, moe={"num_experts": 8, "top_k": 2, "d_ff_expert": 8,
                       "num_shared_experts": 1, "first_dense_layers": 1,
                       "d_ff_dense": 24})


def test_model_flops_by_hand():
    attn = 16 * 16 + 2 * 16 * 8 + 16 * 16            # wq, wk, wv, wo
    head = 16 * 512                                  # vocab padded to 512
    assert costs.matmul_params(DENSE) == head + 2 * (attn + 3 * 16 * 32)
    moe_layer = attn + (2 + 1) * 3 * 16 * 8 + 16 * 8
    assert costs.matmul_params(MOE) == head + attn + 3 * 16 * 24 + moe_layer
    # two tokens over 1 and 2 keys: 2 x weights each, 4 H Dh a key a layer
    assert costs.token_flops(DENSE, [1, 2]) == \
        2 * costs.matmul_params(DENSE) * 2 + 4 * 4 * 4 * 2 * 3

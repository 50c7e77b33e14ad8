"""The yardstick's arithmetic against hand counts at small shapes."""
import pytest

from perfbench import cost

M = dict(n_layers=2, d_model=8, n_heads=4, n_kv_heads=2, head_dim=2,
         d_ff=6, vocab_size=10, n_experts=4, top_k=2, attn_type="swa",
         sliding_window=3)


def test_causal_pairs_by_hand():
    assert cost.causal_pairs(4) == 1 + 2 + 3 + 4
    assert cost.causal_pairs(5, 3) == 1 + 2 + 3 + 3 + 3
    assert cost.causal_pairs(2, 3) == 3
    assert [cost.context(p, 3) for p in range(5)] == [1, 2, 3, 3, 3]


def test_matmul_params_per_token_by_hand():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, router 8x4, 2 experts x 3 x 8x6
    assert cost.matmul_params_per_token(M) == 64 + 32 + 32 + 64 + 32 + 288


def test_prefill_and_decode_flops_by_hand():
    per_tok = 2 * 512
    attn = 4 * cost.causal_pairs(5, 3) * 4 * 2
    assert cost.prefill_flops(M, 5) == 2 * (per_tok * 5 + attn) + 2 * 8 * 10
    # two live sequences at positions 0 and 7: contexts 1 and 3
    assert cost.decode_flops(M, [0, 7]) == (
        2 * (per_tok * 2 + 4 * 4 * 4 * 2) + 2 * 2 * 8 * 10)


def test_attention_bounds_by_hand():
    ops = 4 * cost.causal_pairs(5, 3) * 4 * 2
    nbytes = 2 * 5 * 2 * (2 * 4 + 2 * 2)
    assert cost.prefill_attention_bound_s(M, 5) == pytest.approx(
        max(ops / cost.PEAK_BF16_FLOP_S, nbytes / cost.HBM_BYTES_S))
    # k and v of 1 + 3 keys x 2 kv heads x 2 dims, q and o of 2 sequences
    nbytes = 2 * (2 * 4 * 2 * 2 + 2 * 2 * 4 * 2)
    assert cost.decode_attention_bound_s(M, [0, 7]) == pytest.approx(
        max(4 * 4 * 4 * 2 / cost.PEAK_BF16_FLOP_S, nbytes / cost.HBM_BYTES_S))


def test_full_attention_has_no_window():
    full = dict(M, attn_type="full")
    assert cost.attention_window(M) == 3 and cost.attention_window(full) == 0
    assert cost.attention_window(dict(full, sliding_window=None)) == 0
    # every query sees all earlier keys: 1 + 2 + 3 + 4 + 5 pairs
    ops = 4 * 15 * 4 * 2
    assert cost.prefill_flops(full, 5) == 2 * (2 * 512 * 5 + ops) + 2 * 8 * 10
    # contexts 1 and 8 at positions 0 and 7
    nbytes = 2 * (2 * 9 * 2 * 2 + 2 * 2 * 4 * 2)
    assert cost.decode_attention_bound_s(full, [0, 7]) == pytest.approx(
        max(4 * 9 * 4 * 2 / cost.PEAK_BF16_FLOP_S, nbytes / cost.HBM_BYTES_S))

"""The work functions on shapes worked by hand."""

import pytest

from portbench import work

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 2, "vocab_size": 10,
       "intermediate_size": 16}
MOE = {**CFG, "num_local_experts": 4, "num_experts_per_tok": 2}
PEAK = {"bf16_flops_per_s": 100.0, "hbm_bytes_per_s": 10.0}


def test_layer_params_dense_and_routed():
    # attention: 8*2*(2*4 + 2*2) = 192; dense FFN 3*8*16 = 384
    assert work.layer_params(CFG) == 192 + 384
    # routed: router 8*4 = 32, two experts 2*384
    assert work.layer_params(MOE) == 192 + 32 + 768


def test_causal_attention_flops():
    # positions 0..2 attend to 1+2+3 = 6 keys; 4 * L * H * hd per key
    assert work.attn_flops(CFG, 0, 3) == 4 * 2 * 4 * 2 * 6
    # positions 3..4 over a cached prefix: 4 + 5 keys
    assert work.attn_flops(CFG, 3, 5) == 4 * 2 * 4 * 2 * 9


def test_prefill_bytes_read_the_prefix_once():
    per = work.ELEM_BYTES * 2  # bytes * layers
    # [3, 5) starting at 3: q+o 2*2*4*2 = 32, new K+V 2*2*2*2 = 16,
    # prefix K+V 2*3*2*2 = 24
    assert work.attn_bytes(CFG, 3, 5, 3) == per * (32 + 16 + 24)
    # a later range of the same prompt reads no prefix again
    assert work.attn_bytes(CFG, 5, 7, 3) == per * (32 + 16)


def test_k1_bytes_per_decoded_token():
    # ctx 10: K and V 2*10*2*2 = 80, q and out 2*4*2 = 16, per layer
    assert work.decode_ctx_bytes(CFG, 10) == 2 * 2 * (80 + 16)


def test_decode_flops_include_the_head():
    assert work.decode_flops(CFG, 10) == (
        2 * 576 * 2 + 4 * 2 * 4 * 2 * 10 + 2 * 8 * 10)


def test_bound_is_the_larger_of_compute_and_bytes():
    assert work.bound_s(1000.0, 10.0, PEAK) == 10.0
    assert work.bound_s(10.0, 1000.0, PEAK) == 100.0


def test_mfu_of_a_span_by_hand():
    from portbench.reduce import span_work

    class R:
        config, peak = CFG, PEAK

    steps = [{"prefill": [(0, 3, 0, True)], "decode": [(3, 2, 3)]}]
    w = span_work(R, steps)
    want = (work.prefill_flops(CFG, 0, 3) + work.head_flops(CFG)
            + work.decode_flops(CFG, 4) + work.decode_flops(CFG, 5))
    assert w["flops"] == want
    assert w["decode_tokens"] == 2 and w["prefill_tokens"] == 3
    assert w["k1_bound_s"] == pytest.approx(
        (work.decode_ctx_bytes(CFG, 4) + work.decode_ctx_bytes(CFG, 5))
        / PEAK["hbm_bytes_per_s"])


def test_peaks_table_knows_the_h100():
    assert work.peaks("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert work.peaks("cpu") is None

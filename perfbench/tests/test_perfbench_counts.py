"""The frozen count functions against counts made by hand here, and the
peaks they are read against. CPU only; imports no JAX."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "src"))
                if p not in sys.path]

from perfbench import peaks  # noqa: E402
from perfbench.counts import (decode_attention, flash_attention,  # noqa: E402
                              granite_3_0_1b_a400m, impala_deep, vtrace)


def _config(name):
    return json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                       name + ".json")))


def test_impala_deep_forward_at_atari_shape():
    # section convs, then 4 residual convs at the pooled size, each
    # 2 * 9 * cin * cout * h * w; fc 3872 -> 256; heads 256 -> 19
    hand = (2 * 9 * 4 * 16 * 84 * 84 + 4 * 2 * 9 * 16 * 16 * 42 * 42
            + 2 * 9 * 16 * 32 * 42 * 42 + 4 * 2 * 9 * 32 * 32 * 21 * 21
            + 2 * 9 * 32 * 32 * 21 * 21 + 4 * 2 * 9 * 32 * 32 * 11 * 11
            + 2 * 3872 * 256 + 2 * 256 * 19)
    assert hand == 108_455_424
    got = impala_deep.forward_flops(_config("impala_deep_atari")["agent"])
    assert got == hand


def test_vtrace_launch_counts_what_the_inputs_need():
    flops, nbytes = vtrace.launch(80, 32)
    assert flops == 15 * 80 * 32
    assert nbytes == 4 * (4 * 80 * 32 + 32 + 2 * 80 * 32)


def test_flash_attention_counts_causal_pairs():
    assert flash_attention.pairs(64, 64) == 64 * 65 // 2
    assert flash_attention.pairs(1, 1) == 1
    assert flash_attention.pairs(2, 4, q_offset=2) == 3 + 4
    flops, nbytes = flash_attention.launch(16, 16, 8, 64, 64, 64, 2)
    assert flops == 4 * 16 * 16 * 2080 * 64 == 136_314_880
    assert nbytes == 2 * (2 * 16 * 16 * 64 * 64 + 2 * 16 * 8 * 64 * 64)


def test_decode_attention_counts_valid_slots_only():
    flops, nbytes = decode_attention.launch(16, 16, 8, 10, 64, 2, slots=65)
    assert flops == 4 * 16 * 16 * 10 * 64
    assert nbytes == 2 * (2 * 16 * 8 * 10 * 64 + 2 * 16 * 16 * 64) \
        + 4 * 66


def test_granite_model_flops():
    m = _config("granite_3_0_1b_a400m")["model"]
    layer = (2 * (1024 * 1024 + 2 * 1024 * 512 + 1024 * 1024)
             + 2 * 1024 * 32 + 8 * 3 * 2 * 1024 * 512)
    hand = 24 * layer + 2 * 1024 * 49155 + 2 * 1024
    assert hand == 857_219_072
    assert granite_3_0_1b_a400m.per_token(m) == hand
    attn = 4 * 16 * 16 * 64 * (64 * 65 // 2) * 24
    assert granite_3_0_1b_a400m.forward_flops(m, 16, 64) \
        == 16 * 64 * hand + attn
    assert granite_3_0_1b_a400m.generation_flops(m, 16, 64) \
        == granite_3_0_1b_a400m.forward_flops(m, 16, 64)


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12),
                                        ("bfloat16", 989e12)])
def test_bound_is_the_larger_term(dtype, peak):
    assert peaks.bound_s(peak, 0.0, dtype) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12, dtype) == pytest.approx(1.0)
    assert peaks.bound_s(peak, 2 * 3.35e12, dtype) == pytest.approx(2.0)

"""The port's decoder and server against the JAX reference for the three
families ``tests/test_torch_model.py`` and ``tests/test_torch_serve.py``
do not list: ``mixtral-8x7b`` (8 experts top-2, reduced to 4; ``swa_attn``
with the reduced window of 32, so a 36-token prefill rolls its ring),
``deepseek-coder-33b`` (56 query heads over 8 KV heads: a group of 7,
which the reduced config's 4 over 2 hides, so one case sets 14 over 2 in
both packages) and ``musicgen-large`` (LayerNorm, sinusoidal positions,
GELU, MHA). The checks are those files' own, imported, on these archs."""

import pytest
import torch

import test_torch_model as tm
import test_torch_serve as ts
# the serving contracts, collected here against this module's ``setup``
from test_torch_serve import (  # noqa: F401
    test_admission_eviction_preserves_survivors,
    test_per_request_budget_and_stop_token,
    test_single_request_bitwise_parity_with_generate,
    test_slot_recycling_never_leaks_kv)

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

FAMILIES = ["mixtral-8x7b", "deepseek-coder-33b", "musicgen-large"]
# reduced DeepSeek-Coder with the published group of 7 query heads per KV
# head (56 over 8 at full width)
GROUP_OF_7 = dict(num_heads=14, num_kv_heads=2)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_baseline_match_jax(arch, impl):
    """Logits, baseline and MoE aux within ``tm.TOL``."""
    tm._check_forward(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_match_jax(arch, impl):
    """A 36-token prefill (Mixtral's 32-slot ring rolled), every cache
    leaf, then 8 decode steps at per-row positions."""
    tm._check_prefill_then_decode(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_group_of_7_forward_matches_jax(impl):
    cfg = tm._setup("deepseek-coder-33b", **GROUP_OF_7)[1]
    assert cfg.num_heads // cfg.num_kv_heads == 7
    tm._check_forward("deepseek-coder-33b", impl, **GROUP_OF_7)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_group_of_7_prefill_then_decode_match_jax(impl):
    tm._check_prefill_then_decode("deepseek-coder-33b", impl, **GROUP_OF_7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_teacher_forced_generate_stream_matches_jax(arch):
    tm.test_teacher_forced_generate_stream_matches_jax(arch)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_and_off_give_the_same_values_and_grads(arch, impl):
    tm.test_remat_on_and_off_give_the_same_values_and_grads(arch, impl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_converter_round_trip(arch):
    tm.test_converter_round_trip(arch)


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    return ts._setup(request.param)


@pytest.mark.parametrize("arch", FAMILIES)
def test_session_teacher_forced_matches_jax(monkeypatch, arch):
    """The port's DecodeSession against the reference's: two slots
    admitted, decoded, one evicted and refilled, the reference's tokens
    forced; logprob, entropy and baseline within 1e-4."""
    ts._session_teacher_forced(monkeypatch, arch)

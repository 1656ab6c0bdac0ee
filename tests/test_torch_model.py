"""The port's decoder against the JAX reference: configs field for field,
the LM parameter converter, whole-model forward, prefill + decode, logits,
baseline and MoE aux for the reduced ``qwen3-4b``, ``gemma2-27b`` (window,
both softcaps, sandwich norms, GeGLU), ``zamba2-2.7b`` (Mamba2 layers and
the shared attention block, also at the published head_dim 80) and
``granite-moe-1b-a400m`` (MoE FFNs, dropless at the reduced capacity 4.0),
``xlstm-125m`` (an mLSTM and an sLSTM layer) and ``llama-3.2-vision-90b``
(a self-attention and a cross-attention layer, fed a seeded vision
input), the same in bf16, and teacher forcing of JAX ``generate``'s token
stream through the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ImplContext as JImplContext
from repro.core import generate as jgen
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ImplContext
from repro_torch.convert import lm_state_dict_from_jax, lm_state_dict_to_jax
from repro_torch.core.generate import logprob_entropy
from repro_torch.models import model as tmodel

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_attn_impl.py's float32 bar
ARCHS = ["qwen3-4b", "gemma2-27b", "zamba2-2.7b", "granite-moe-1b-a400m",
         "xlstm-125m", "llama-3.2-vision-90b"]
# Mamba2 and mLSTM take sequences of at most one chunk (16 tokens reduced)
# or a multiple of it, as in the reference: their lengths are multiples
FORWARD_LEN = {"zamba2-2.7b": 48, "xlstm-125m": 48}
PREFILL_LEN = {"zamba2-2.7b": 32, "xlstm-125m": 32}


def _setup(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get_reduced_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_reduced_config(arch), **over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.init(tcfg, seed=0)
    tparams.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _vision(cfg, batch, seed=11):
    """A VLM's seeded patch embeddings as (JAX, port) inputs; (None, None)
    for the other archs."""
    if not cfg.vision_seq:
        return None, None
    v = np.random.default_rng(seed).normal(
        0, 1, (batch, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(v), torch.from_numpy(v)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    for key, child in tree.items():
        if isinstance(child, dict):
            yield from _leaves(child, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", child


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# configs and converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_jax_field_for_field(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    for get in ("get_config", "get_reduced_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("resolved_head_dim", "num_layers", "is_recurrent",
                     "is_subquadratic"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.param_count() == want.param_count()


def test_impl_context_folds_flags_like_the_reference():
    tcfg = tconfigs.get_reduced_config("qwen3-4b")
    jcfg = jconfigs.get_reduced_config("qwen3-4b")
    for attn, ssd in [("kernel", None), ("xla", "kernel"), (None, None)]:
        got = ImplContext(attn=attn, ssd=ssd).apply(tcfg)
        want = JImplContext(attn=attn, ssd=ssd).apply(jcfg)
        assert (got.attn_impl, got.ssd_impl) == (want.attn_impl,
                                                 want.ssd_impl)
    assert ImplContext().apply(tcfg) is tcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_converter_round_trip(arch):
    """JAX tree -> state_dict -> the port's tree (strict: every name and
    shape matches init's) -> JAX tree, bitwise; leaves keep their JAX
    layouts and the group axis is unstacked."""
    _, tcfg, jparams, tparams = _setup(arch)
    sd = tparams.state_dict()
    d, h, hd = tcfg.d_model, tcfg.num_heads, tcfg.resolved_head_dim
    mixers = [m for m, _ in tcfg.block_pattern]
    attn = ("shared.l0" if tcfg.shared_attn_every
            else "blocks.0.l0" if mixers[0].endswith("attn") else None)
    if attn is not None:
        assert tuple(sd[f"{attn}.mixer.wq"].shape) == (d, h, hd)
        assert tuple(sd[f"{attn}.mixer.wo"].shape) == (h, hd, d)
    if "mamba" in mixers:
        # Mamba2 leaves keep the reference's layouts: conv_w (W, C)
        assert tuple(sd["blocks.0.l0.mixer.conv_w"].shape) == (
            tcfg.ssm_conv_width,
            tcfg.ssm_expand * d + 2 * tcfg.ssm_state)
    if "mlstm" in mixers:
        # xLSTM leaves too: mLSTM wq (d, H, dh), wo (d, d); sLSTM wx (d,
        # 4, H, dh), wr (4, H, dh, dh)
        dh = d // h
        assert tuple(sd["blocks.0.l0.mixer.wq"].shape) == (d, h, dh)
        assert tuple(sd["blocks.0.l0.mixer.wo"].shape) == (d, d)
        assert tuple(sd["blocks.0.l1.mixer.wx"].shape) == (d, 4, h, dh)
        assert tuple(sd["blocks.0.l1.mixer.wr"].shape) == (4, h, dh, dh)
    back = lm_state_dict_to_jax(sd)
    flat_want = jax.tree_util.tree_leaves_with_path(jparams)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, got), (_, want) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)


def test_every_arch_initialises_with_the_reference_leaves():
    """Every arch of the registry (reduced) initialises in the port, with
    the reference's leaf names and shapes (its group axis unstacked)."""
    for arch in tconfigs.ARCHS:
        jparams, _ = jmodel.init(jax.random.PRNGKey(0),
                                 jconfigs.get_reduced_config(arch))
        want = {k: tuple(v.shape)
                for k, v in lm_state_dict_from_jax(jparams).items()}
        got = {k: tuple(v.shape) for k, v in tmodel.init(
            tconfigs.get_reduced_config(arch)).state_dict().items()}
        assert got == want, arch


# ---------------------------------------------------------------------------
# forward, prefill + decode, logits and baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_baseline_match_jax(arch, impl):
    """``impl`` picks both the attention and the Mamba2 SSD path."""
    _check_forward(arch, impl)


def _check_forward(arch, impl, **over):
    """``test_forward_logits_baseline_match_jax`` on ``arch`` with the
    config fields ``over`` set in both packages."""
    jcfg, tcfg, jparams, tparams = _setup(arch, ssd_impl=impl, **over)
    tokens = _tokens(tcfg, (2, FORWARD_LEN.get(arch, 40)))
    jvis, tvis = _vision(tcfg, 2)
    want_l, want_b, want_aux = jmodel.apply_lm(jparams, jnp.asarray(tokens),
                                               cfg=jcfg, vision=jvis,
                                               impl=impl)
    with torch.no_grad():
        got_l, got_b, got_aux = tmodel.apply_lm(
            tparams, torch.from_numpy(tokens), cfg=tcfg, vision=tvis,
            impl=impl)
    np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, **TOL)
    for got, want in zip(got_aux, want_aux):   # zeros without MoE
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch, impl):
    """A 36-token prefill (past gemma2's 32-token window: the ring is
    rolled; zamba2 and xlstm: two 16-token chunks, the state carried
    through the SSD chunk or the mLSTM's chunk step; the VLM: its xattn
    cache holds the vision k/v) builds the reference's caches, every
    subtree and leaf of them, and 8 decode steps at per-row positions
    (wrapping the ring) track its logits and baseline."""
    _check_prefill_then_decode(arch, impl)


def _check_prefill_then_decode(arch, impl, **over):
    """``test_prefill_then_decode_match_jax`` on ``arch`` with the config
    fields ``over`` set in both packages."""
    jcfg, tcfg, jparams, tparams = _setup(arch, ssd_impl=impl, **over)
    p, n = PREFILL_LEN.get(arch, 36), 8
    tokens = _tokens(tcfg, (2, p + n), seed=2)
    jvis, tvis = _vision(tcfg, 2)
    _, _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :p]),
                                  cfg=jcfg, vision=jvis, impl=impl,
                                  cache_seq_len=p + n)
    with torch.no_grad():
        _, _, tcache = tmodel.prefill(
            tparams, torch.from_numpy(tokens[:, :p]), cfg=tcfg, vision=tvis,
            impl=impl, cache_seq_len=p + n)
    paths = [path for path, _ in _leaves(tcache)]
    assert paths == [path for path, _ in _leaves(jcache)]
    for path, got in _leaves(tcache):
        np.testing.assert_allclose(got.numpy(), _at(jcache, path), **TOL,
                                   err_msg=path)
    for t in range(p, p + n):
        pos = np.full((2,), t, np.int32)
        want_l, want_b, jcache = jmodel.serve_step(
            jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
            jnp.asarray(pos), cfg=jcfg, unroll=True, impl=impl)
        with torch.no_grad():
            got_l, got_b, tcache = tmodel.serve_step(
                tparams, torch.from_numpy(tokens[:, t:t + 1]), tcache,
                torch.from_numpy(pos), cfg=tcfg, impl=impl)
        np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)
        np.testing.assert_allclose(got_b.numpy(), want_b, **TOL)


def test_zamba2_head_dim_80_matches_jax():
    """The published shared-block head_dim (80) on the reduced hybrid, in
    float32 through both kernels' plain versions: forward logits, then a
    16-token prefill and 4 decode steps."""
    jcfg, tcfg, jparams, tparams = _setup("zamba2-2.7b", head_dim=80,
                                          attn_impl="kernel",
                                          ssd_impl="kernel")
    assert tparams["shared"]["l0"]["mixer"]["wq"].shape[-1] == 80
    p, n = 16, 4
    tokens = _tokens(tcfg, (2, p + n), seed=5)
    want_l, want_b, _ = jmodel.apply_lm(jparams, jnp.asarray(tokens[:, :p]),
                                        cfg=jcfg)
    with torch.no_grad():
        got_l, got_b, _ = tmodel.apply_lm(tparams,
                                          torch.from_numpy(tokens[:, :p]),
                                          cfg=tcfg)
    np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, **TOL)
    _, _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :p]),
                                  cfg=jcfg, cache_seq_len=p + n)
    with torch.no_grad():
        _, _, tcache = tmodel.prefill(
            tparams, torch.from_numpy(tokens[:, :p]), cfg=tcfg,
            cache_seq_len=p + n)
    for t in range(p, p + n):
        want_l, _, jcache = jmodel.serve_step(
            jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t),
            cfg=jcfg, unroll=True)
        with torch.no_grad():
            got_l, _, tcache = tmodel.serve_step(
                tparams, torch.from_numpy(tokens[:, t:t + 1]), tcache, t,
                cfg=tcfg)
        np.testing.assert_allclose(got_l.numpy(), want_l, **TOL)


# bf16 activations: both packages round to bf16 at the same ops
# (projections, norms, residual adds, the unembedding), but XLA on the CPU
# may keep float32 between the elementwise ops it fuses (its default
# excess precision) where the port rounds every op's result, and the
# float32 sums run in other orders. So every logit moves a little: by at
# most 0.030 on logits up to 3.5 when this bar was set (qwen3-4b reduced,
# two layers). The bar, 6e-2 absolute, is twice that.
BF16_TOL = dict(rtol=0, atol=6e-2)


def test_bf16_forward_and_decode_match_jax():
    jcfg, tcfg, jparams, tparams = _setup("qwen3-4b", dtype="bfloat16")
    p, n = 12, 4
    tokens = _tokens(tcfg, (2, p + n), seed=3)
    want_l, want_b, _ = jmodel.apply_lm(jparams, jnp.asarray(tokens[:, :p]),
                                        cfg=jcfg, impl="kernel")
    with torch.no_grad():
        got_l, got_b, _ = tmodel.apply_lm(tparams,
                                          torch.from_numpy(tokens[:, :p]),
                                          cfg=tcfg, impl="kernel")
    np.testing.assert_allclose(got_l.numpy(), want_l, **BF16_TOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, **BF16_TOL)
    _, _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :p]),
                                  cfg=jcfg, cache_seq_len=p + n)
    with torch.no_grad():
        _, _, tcache = tmodel.prefill(
            tparams, torch.from_numpy(tokens[:, :p]), cfg=tcfg,
            cache_seq_len=p + n)
    assert tcache["block"]["l0"]["k"].dtype == torch.bfloat16
    for t in range(p, p + n):
        want_l, want_b, jcache = jmodel.serve_step(
            jparams, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t),
            cfg=jcfg, impl="kernel")
        with torch.no_grad():
            got_l, got_b, tcache = tmodel.serve_step(
                tparams, torch.from_numpy(tokens[:, t:t + 1]), tcache, t,
                cfg=tcfg, impl="kernel")
        assert got_l.dtype == torch.float32
        np.testing.assert_allclose(got_l.numpy(), want_l, **BF16_TOL)
        np.testing.assert_allclose(got_b.numpy(), want_b, **BF16_TOL)


# ---------------------------------------------------------------------------
# teacher forcing: JAX generate's stream through the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_generate_stream_matches_jax(arch):
    """The two frameworks' samplers draw different numbers from a seed, so
    cross-framework parity is logit-level: JAX ``generate``'s sampled
    tokens are fed through the port's prefill and decode, and the port's
    per-step logprob, entropy and baseline must agree within 1e-4."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    p, n, temp = 6, 10, 0.7
    prompt = _tokens(tcfg, (2, p), seed=4)
    jvis, tvis = _vision(tcfg, 2)
    ref = jax.tree.map(np.asarray, jgen.generate(
        jparams, jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(9),
        cfg=jcfg, num_steps=n, temperature=temp, vision=jvis))
    stream = torch.from_numpy(ref["tokens"].astype(np.int64))
    lps, ents, bases = [], [], []
    with torch.no_grad():
        hidden, _, cache = tmodel.prefill(tparams, stream[:, :p], cfg=tcfg,
                                          vision=tvis, cache_seq_len=p + n)
        h = hidden[:, -1:]
        for t in range(p, p + n):
            logits = tmodel.logits_from_hidden(tparams, tcfg, h)[:, 0]
            lp, ent = logprob_entropy(logits / temp, stream[:, t])
            lps.append(lp)
            ents.append(ent)
            bases.append(tmodel.baseline_from_hidden(tparams, tcfg, h)[:, 0])
            h, cache = tmodel.decode_step(tparams, stream[:, t:t + 1], cache,
                                          t, cfg=tcfg)
    for got, key in [(lps, "logprob"), (ents, "entropy"),
                     (bases, "baseline")]:
        np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref[key],
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_values_and_grads(arch, impl):
    """``cfg.remat`` (checkpoint regions per group, and per layer of a
    multi-layer group: gemma2's pair, zamba2's Mamba2 layers, the xLSTM's
    (mLSTM, sLSTM) pair, the VLM's pair) changes what
    autograd keeps, not what it computes: the hidden states, the MoE aux
    (its router losses in the loss) and every parameter's gradient are
    bitwise those without it."""
    runs = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tconfigs.get_reduced_config(arch),
                                  remat=remat, attn_impl=impl, ssd_impl=impl)
        params = tmodel.init(cfg, seed=0)
        tokens = torch.from_numpy(_tokens(cfg, (2, FORWARD_LEN.get(arch, 40))))
        hidden, aux, _ = tmodel.forward(params, tokens, cfg=cfg,
                                        vision=_vision(cfg, 2)[1])
        loss = torch.sum(torch.square(hidden)) \
            + tmodel.baseline_from_hidden(params, cfg, hidden).sum() \
            + aux[0] + aux[1]
        if not cfg.tie_embeddings:      # the VLM's unembedding
            loss = loss + tmodel.logits_from_hidden(params, cfg,
                                                    hidden).mean()
        names, plist = zip(*params.named_parameters())
        runs[remat] = (hidden.detach(), [a.detach() for a in aux], names,
                       torch.autograd.grad(loss, plist))
    (h0, a0, n0, g0), (h1, a1, n1, g1) = runs[False], runs[True]
    assert torch.equal(h0, h1) and n0 == n1
    assert all(torch.equal(x, y) for x, y in zip(a0, a1))
    for name, a, b in zip(n0, g0, g1):
        assert torch.equal(a, b), name

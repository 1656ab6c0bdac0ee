"""The port's VLM path against the JAX reference: cross-attention
(``xattn``) in ``attn_apply`` (every impl; ``kernel`` takes the chunked
plain path, the kernel being causal), ``attn_prefill_cache`` and
``attn_decode`` (dense against the static vision cache, nothing written),
the reference's permutation test of ``xattn`` on the port; then the
reduced ``llama-3.2-vision-90b`` (a self-attention and a cross-attention
layer) with a seeded vision input: ``apply_lm``, ``prefill`` +
``serve_step`` (against the reference and against the port's own
forward), ``generate(vision=)``, one ``make_lm_pretrain_step`` AdamW step
with vision, and ``DecodeSession`` refusing a vision config in both
packages.

Tolerance: float32 at 1e-5 (tests/test_attn_impl.py's bar); decode
against the full forward and sampled streams re-scored by the other
package at 1e-4 (tests/test_torch_model.py's teacher-forcing bar); the
reference's permutation test keeps its 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import generate as jgen
from repro.core import learner as jlearner
from repro.models import attention as JA
from repro.models import model as jmodel
from repro.models.common import split_params
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.convert import lm_state_dict_from_jax, lm_state_dict_to_jax
from repro_torch.core import generate as tgen
from repro_torch.core import learner as tlearner
from repro_torch.core.generate import logprob_entropy
from repro_torch.models import attention as TA
from repro_torch.models import model as tmodel
from repro_torch.optim import make_optimizer as tmake_optimizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
STREAM_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llama-3.2-vision-90b"
IMPLS = ["xla", "xla_chunked", "xla_chunked_skip", "kernel"]


def _cfgs(**over):
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH), **over),
            dataclasses.replace(tconfigs.get_reduced_config(ARCH), **over))


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(0, 1, shape)).astype(
        np.float32)


def _vision(cfg, b, seed=20):
    return _normal((b, cfg.vision_seq, cfg.d_model), seed)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# xattn
# ---------------------------------------------------------------------------

def _xattn_params(jcfg, tcfg):
    jp = split_params(JA.attn_init(jax.random.PRNGKey(0), jcfg, "xattn"))[0]
    tp = TA.attn_init(tcfg, "xattn", generator=torch.Generator())
    tp.load_state_dict({k: torch.tensor(np.asarray(v))
                        for k, v in jp.items()}, strict=True)
    return jp, tp


@pytest.mark.parametrize("impl", IMPLS)
def test_xattn_apply_matches_jax(impl):
    """16 text tokens against 16 vision positions in chunks of 8 (two
    query chunks, two KV chunks): the output and the vision k, v."""
    jcfg, tcfg = _cfgs(attn_chunk=8)
    jp, tp = _xattn_params(jcfg, tcfg)
    x = _normal((2, 16, tcfg.d_model), 1)
    vis = _vision(tcfg, 2)
    pos = np.arange(16)
    want, (wk, wv) = JA.attn_apply(jp, jnp.asarray(x), cfg=jcfg,
                                   kind="xattn", positions=jnp.asarray(pos),
                                   kv_src=jnp.asarray(vis), impl=impl)
    with torch.no_grad():
        got, (gk, gv) = TA.attn_apply(tp, torch.from_numpy(x), cfg=tcfg,
                                      kind="xattn",
                                      positions=torch.from_numpy(pos),
                                      kv_src=torch.from_numpy(vis),
                                      impl=impl)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


def test_xattn_launches_no_kernel(monkeypatch):
    """Under ``kernel`` neither attention kernel's wrapper is called: the
    flash-attention kernel is causal, and decode reads the static cache
    densely."""
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("xattn called an attention kernel")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    monkeypatch.setattr(ops, "decode_attention", refuse)
    _, tcfg = _cfgs()
    tp = TA.attn_init(tcfg, "xattn", generator=torch.Generator())
    x = torch.from_numpy(_normal((2, 4, tcfg.d_model), 2))
    vis = torch.from_numpy(_vision(tcfg, 2))
    with torch.no_grad():
        _, kv = TA.attn_apply(tp, x, cfg=tcfg, kind="xattn",
                              positions=torch.arange(4), kv_src=vis,
                              impl="kernel")
        cache = TA.attn_prefill_cache(tcfg, "xattn", kv, 12, torch.float32)
        TA.attn_decode(tp, x[:, :1], cache, cfg=tcfg, kind="xattn", pos=4,
                       impl="kernel")


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_xattn_prefill_cache_and_decode_match_jax(impl):
    """The vision k/v cache (capacity ``vision_seq``, whatever the text
    length), then decode steps at per-row and scalar positions: outputs
    as the reference's, the cache left as it was."""
    jcfg, tcfg = _cfgs()
    jp, tp = _xattn_params(jcfg, tcfg)
    x = _normal((2, 6, tcfg.d_model), 3)
    vis = _vision(tcfg, 2, seed=21)
    pos = np.arange(3)
    _, jkv = JA.attn_apply(jp, jnp.asarray(x[:, :3]), cfg=jcfg, kind="xattn",
                           positions=jnp.asarray(pos),
                           kv_src=jnp.asarray(vis), impl=impl)
    with torch.no_grad():
        _, tkv = TA.attn_apply(tp, torch.from_numpy(x[:, :3]), cfg=tcfg,
                               kind="xattn", positions=torch.from_numpy(pos),
                               kv_src=torch.from_numpy(vis), impl=impl)
    jc = JA.attn_prefill_cache(jcfg, "xattn", jkv, 40, jnp.float32)
    tc = TA.attn_prefill_cache(tcfg, "xattn", tkv, 40, torch.float32)
    assert tc["k"].shape == (2, tcfg.vision_seq, tcfg.num_kv_heads,
                             tcfg.resolved_head_dim)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    kept = {key: v.clone() for key, v in tc.items()}
    for t in range(3, 6):
        for p in (np.full((2,), t, np.int32), np.int32(t)):
            want, jc = JA.attn_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                      cfg=jcfg, kind="xattn",
                                      pos=jnp.asarray(p), impl=impl)
            with torch.no_grad():
                got, tc = TA.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                         tc, cfg=tcfg, kind="xattn",
                                         pos=torch.as_tensor(p), impl=impl)
            _close(got, want)
    for key in kept:
        assert torch.equal(tc[key], kept[key])


def test_cross_attention_ignores_causal():
    """The reference's test on the port: permuting the query positions
    permutes the outputs identically (no causal mask)."""
    _, tcfg = _cfgs(vision_seq=24)
    tp = TA.attn_init(tcfg, "xattn",
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_normal((2, 16, tcfg.d_model), 4))
    vis = torch.from_numpy(_normal((2, 24, tcfg.d_model), 5))
    pos = torch.arange(16)
    with torch.no_grad():
        o, (k, _) = TA.attn_apply(tp, x, cfg=tcfg, kind="xattn",
                                  positions=pos, kv_src=vis, impl="xla")
        assert k.shape[1] == 24
        perm = torch.arange(15, -1, -1)
        o2, _ = TA.attn_apply(tp, x[:, perm], cfg=tcfg, kind="xattn",
                              positions=pos, kv_src=vis, impl="xla")
    torch.testing.assert_close(o[:, perm], o2, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the reduced VLM
# ---------------------------------------------------------------------------

def _setup(**over):
    jcfg, tcfg = _cfgs(**over)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.init(tcfg, seed=0)
    tparams.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    return jcfg, tcfg, jparams, tparams


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_vlm_apply_lm_matches_jax(impl):
    jcfg, tcfg, jparams, tparams = _setup()
    tokens = _tokens(tcfg, (2, 20), 6)
    vis = _vision(tcfg, 2)
    want_l, want_b, _ = jmodel.apply_lm(jparams, jnp.asarray(tokens),
                                        cfg=jcfg, vision=jnp.asarray(vis),
                                        impl=impl)
    with torch.no_grad():
        got_l, got_b, _ = tmodel.apply_lm(tparams, torch.from_numpy(tokens),
                                          cfg=tcfg,
                                          vision=torch.from_numpy(vis),
                                          impl=impl)
    _close(got_l, want_l)
    _close(got_b, want_b)


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_vlm_prefill_then_decode_match_jax(impl):
    """A 12-token prefill with vision builds the reference's caches (the
    xattn layer's: the vision k/v), and 6 decode steps track the
    reference's logits and baseline, and the port's own forward over the
    whole sequence."""
    jcfg, tcfg, jparams, tparams = _setup()
    p, n = 12, 6
    tokens = _tokens(tcfg, (2, p + n), 7)
    vis = _vision(tcfg, 2, seed=22)
    _, _, jcache = jmodel.prefill(jparams, jnp.asarray(tokens[:, :p]),
                                  cfg=jcfg, vision=jnp.asarray(vis),
                                  impl=impl, cache_seq_len=p + n)
    with torch.no_grad():
        full, _, _ = tmodel.apply_lm(tparams, torch.from_numpy(tokens),
                                     cfg=tcfg, vision=torch.from_numpy(vis),
                                     impl=impl)
        _, _, tcache = tmodel.prefill(tparams, torch.from_numpy(tokens[:, :p]),
                                      cfg=tcfg, vision=torch.from_numpy(vis),
                                      impl=impl, cache_seq_len=p + n)
    for layer in ("l0", "l1"):
        for key in ("k", "v"):
            _close(tcache["block"][layer][key], jcache["block"][layer][key],
                   msg=f"{layer}/{key}")
    assert tcache["block"]["l1"]["k"].shape[2] == tcfg.vision_seq
    for t in range(p, p + n):
        pos = np.full((2,), t, np.int32)
        want_l, want_b, jcache = jmodel.serve_step(
            jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
            jnp.asarray(pos), cfg=jcfg, unroll=True, impl=impl)
        with torch.no_grad():
            got_l, got_b, tcache = tmodel.serve_step(
                tparams, torch.from_numpy(tokens[:, t:t + 1]), tcache,
                torch.from_numpy(pos), cfg=tcfg, impl=impl)
        _close(got_l, want_l)
        _close(got_b, want_b)
        _close(got_l[:, 0], full[:, t].numpy(), STREAM_TOL)


def test_vlm_generate_matches_jax():
    """The port's ``generate(vision=)`` has the reference's outputs (keys
    and shapes), and its sampled stream re-scored by the reference's
    forward with the same vision input gives its log-probs, entropies
    and baselines."""
    jcfg, tcfg, jparams, tparams = _setup()
    p, n, temp = 6, 8, 0.7
    prompt = _tokens(tcfg, (2, p), 8)
    vis = _vision(tcfg, 2, seed=23)
    out = tgen.generate(tparams, prompt, 3, cfg=tcfg, num_steps=n,
                        temperature=temp, vision=torch.from_numpy(vis))
    ref = jgen.generate(jparams, jnp.asarray(prompt, jnp.int32),
                        jax.random.PRNGKey(3), cfg=jcfg, num_steps=n,
                        temperature=temp, vision=jnp.asarray(vis))
    assert {k: tuple(v.shape) for k, v in out.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    stream = out["tokens"].numpy()
    np.testing.assert_array_equal(stream[:, :p], prompt)
    logits, base, _ = jmodel.apply_lm(jparams, jnp.asarray(stream[:, :-1]),
                                      cfg=jcfg, vision=jnp.asarray(vis))
    logits = torch.from_numpy(np.array(logits)[:, p - 1:])
    lp, ent = logprob_entropy(logits.reshape(-1, logits.shape[-1]) / temp,
                              torch.from_numpy(stream[:, p:]).reshape(-1))
    _close(out["logprob"], lp.reshape(2, n).numpy(), STREAM_TOL, "logprob")
    _close(out["entropy"], ent.reshape(2, n).numpy(), STREAM_TOL, "entropy")
    _close(out["baseline"], np.asarray(base)[:, p - 1:], STREAM_TOL,
           "baseline")


def test_vlm_pretrain_step_matches_jax():
    """One AdamW step of ``make_lm_pretrain_step`` with the vision input
    in the batch, kernel impl, remat on: the loss, and every parameter
    within the tolerance but at most one element in 10,000 of a leaf,
    which lies within half a step (tests/test_torch_lm_learner.py)."""
    lr = 3e-4
    jcfg, tcfg, jparams, tparams = _setup(attn_impl="kernel", remat=True)
    train = dict(optimizer="adamw", learning_rate=lr, grad_clip=1.0,
                 total_steps=2, lr_schedule="cosine", warmup_steps=10)
    jopt, topt = (jmake_optimizer(JTrainConfig(**train)),
                  tmake_optimizer(TTrainConfig(**train)))
    tokens = _tokens(tcfg, (2, 17), 9).astype(np.int32)
    vis = _vision(tcfg, 2, seed=24)
    jparams, _, jm = jax.jit(jlearner.make_lm_pretrain_step(
        jcfg, jopt, loss_chunk=16))(
            jparams, jopt.init(jparams), jnp.int32(0),
            {"tokens": jnp.asarray(tokens), "vision": jnp.asarray(vis)})
    tparams, _, tm = tlearner.make_lm_pretrain_step(tcfg, topt,
                                                    loss_chunk=16)(
        tparams, topt.init(list(tparams.parameters())), 0,
        {"tokens": torch.from_numpy(tokens), "vision": torch.from_numpy(vis)})
    _close(tm["loss"], jm["loss"])
    got = lm_state_dict_to_jax(tparams.state_dict())
    want = jax.tree.map(np.asarray, jparams)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = np.asarray(flat_got[path])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=lr / 2,
                                   err_msg=str(path))
        outside = int((~np.isclose(g, w, **TOL)).sum())
        assert outside <= max(1, w.size // 10_000), (path, outside)


def test_decode_session_refuses_a_vision_config_in_both_packages():
    jcfg, tcfg, jparams, tparams = _setup()
    with pytest.raises(ValueError, match="text-only"):
        jgen.DecodeSession(jparams, jcfg, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="text-only"):
        tgen.DecodeSession(tparams, tcfg, max_batch=2, max_len=16)

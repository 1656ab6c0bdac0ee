"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference (``repro.models.moe``), from the same weights on numpy inputs
made from a seed:

* routing index for index: the top-k expert indices (ties to the lower
  index, as ``jax.lax.top_k``) and the capacity keep mask, at the reduced
  Mixtral and Granite configs and at Granite's published 32 experts top-8
  on a narrow width, each dropless (capacity factor 4.0) and dropping
  (1.25), over one group and over two groups of 512 tokens;
* ``moe_apply``'s output and aux (load balance, z-loss, dropped fraction)
  at 1e-5 in float32 and 6e-2 in bf16 (the decoder's bf16 bar,
  tests/test_torch_model.py);
* the router's and the experts' gradients against ``jax.grad`` at 1e-5.

Expert outputs and gradients are sums of a few hundred float32 products
that reach tens (outputs) and 1e5 (gradients of sum(out^2)); two
summation orders then differ by more than 1e-5 absolute on the elements
that cancel to near zero. So outputs and gradients are held at rtol 1e-5
and an atol of 1e-5 times the largest magnitude of the reference's array
(``_scaled``); the aux scalars at 1e-5 plainly.
* the four invariants of tests/test_moe.py on the port alone;
* the reference's group-size contract, which the port raises as a
  ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jreduced
from repro.models import moe as jmoe
from repro.models.common import split_params
from repro_torch.configs import get_reduced_config
from repro_torch.models import blocks
from repro_torch.models import moe

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=6e-2, atol=6e-2)}
# (arch, overrides): the reduced configs (4 experts top-2) and Granite's
# published expert count and top-k on the reduced width
CONFIGS = {
    "mixtral": ("mixtral-8x7b", {}),
    "granite": ("granite-moe-1b-a400m", {}),
    "granite-32x8": ("granite-moe-1b-a400m",
                     dict(num_experts=32, num_experts_per_tok=8, d_model=64,
                          moe_d_ff=32)),
}
CAPACITY = {"dropless": 4.0, "dropping": 1.25}
SHAPES = {"one-group": (2, 64), "two-groups": (4, 256)}


def _cfgs(name, capacity=4.0, **over):
    arch, base = CONFIGS[name]
    over = dict(base, capacity_factor=capacity, **over)
    return (dataclasses.replace(jreduced(arch), **over),
            dataclasses.replace(get_reduced_config(arch), **over))


def _params(jcfg, seed=0):
    jp = split_params(jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))[0]
    tp = moe.moe_init(jcfg, generator=torch.Generator().manual_seed(seed))
    tp.load_state_dict({k: torch.tensor(np.asarray(v))
                        for k, v in jp.items()}, strict=True)
    return jp, tp


def _x(cfg, shape, seed=1):
    """Tokens sharing one random direction, so that the router favours
    some experts over others and capacity 1.25 drops token-slots. Their
    scale (RMS about 0.35) keeps the experts' outputs within a few tens:
    the reference's expert init scales by 1/sqrt(E), not the fan-in, and
    at unit inputs float32 sums of outputs in the hundreds differ by more
    than 1e-5 between any two summation orders."""
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal(cfg.d_model)
    return (0.25 * (rng.standard_normal(shape + (cfg.d_model,))
                    + shared)).astype(np.float32)


def _scaled(want, tol):
    """``tol`` with its atol taken relative to the largest |want|."""
    return dict(tol, atol=tol["atol"] * max(1.0, float(np.abs(want).max())))


def _jax_routing(jp, x, cfg):
    """The reference's top-k indices and keep mask, by its own lines
    (``repro.models.moe.moe_apply``, which returns neither)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    gs = min(jmoe.MOE_GROUP_SIZE, b * s)
    xt = x.reshape(-1, gs, d)
    logits = jnp.einsum("gnd,de->gne", xt, jp["router"],
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = onehot.reshape(xt.shape[0], gs * k, e)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos_in_expert = jnp.sum(pos.reshape(onehot.shape) * onehot, axis=-1)
    keep = pos_in_expert < jmoe._capacity(cfg, gs)
    return np.asarray(idx), np.asarray(keep)


def _port_routing(tp, x, cfg):
    b, s, d = x.shape
    gs = min(moe.MOE_GROUP_SIZE, b * s)
    with torch.no_grad():
        xt = x.reshape(-1, gs, d).float()
        probs = torch.softmax(xt @ tp["router"], dim=-1)
        _, idx = moe.route(probs, cfg.num_experts_per_tok)
        onehot = torch.nn.functional.one_hot(idx, cfg.num_experts).float()
        _, keep = moe.capacity_slots(onehot, moe._capacity(cfg, gs))
    return idx.numpy(), keep.numpy().astype(bool)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routing_matches_jax_index_for_index(name, capacity, shape):
    jcfg, tcfg = _cfgs(name, CAPACITY[capacity])
    jp, tp = _params(jcfg)
    x = _x(tcfg, SHAPES[shape])
    jidx, jkeep = _jax_routing(jp, jnp.asarray(x), jcfg)
    tidx, tkeep = _port_routing(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert jkeep.all() == (capacity == "dropless")


def test_ties_go_to_the_lower_index_as_in_jax():
    """A zero router makes every probability equal: both packages route
    every token to experts 0..k-1, in that order."""
    jcfg, tcfg = _cfgs("granite-32x8")
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        tp["router"].zero_()
    x = _x(tcfg, (2, 16))
    jidx, _ = _jax_routing(jp, jnp.asarray(x), jcfg)
    tidx, _ = _port_routing(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    assert (tidx == np.arange(tcfg.num_experts_per_tok)).all()


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("name", ["mixtral", "granite", "granite-32x8"])
def test_moe_apply_matches_jax(name, capacity, shape, dtype):
    jcfg, tcfg = _cfgs(name, CAPACITY[capacity])
    jp, tp = _params(jcfg)
    x = _x(tcfg, SHAPES[shape])
    want, want_aux = jmoe.moe_apply(jp, jnp.asarray(x, dtype), jcfg)
    with torch.no_grad():
        got, got_aux = moe.moe_apply(
            tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **_scaled(want, TOLS[dtype]))
    for field in moe.MoEAux._fields:
        np.testing.assert_allclose(
            getattr(got_aux, field).numpy(),
            np.asarray(getattr(want_aux, field)), **TOLS["float32"],
            err_msg=field)
    assert (float(got_aux.dropped_frac) > 0) == (capacity == "dropping")


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("name", ["mixtral", "granite-32x8"])
def test_router_and_expert_gradients_match_jax(name, capacity):
    """d/d params of sum(out^2) + load_balance + z_loss: the router's
    gradient comes through the renormalised top-k probabilities and the
    aux losses only, in both packages."""
    jcfg, tcfg = _cfgs(name, CAPACITY[capacity])
    jp, tp = _params(jcfg)
    x = _x(tcfg, SHAPES["one-group"])

    def jloss(p):
        out, aux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
        return jnp.sum(jnp.square(out)) + aux.load_balance + aux.z_loss

    want = jax.grad(jloss)(jp)
    out, aux = moe.moe_apply(tp, torch.from_numpy(x), tcfg)
    loss = torch.sum(torch.square(out)) + aux.load_balance + aux.z_loss
    names, plist = zip(*tp.named_parameters())
    for name_, g in zip(names, torch.autograd.grad(loss, plist)):
        w = np.asarray(want[name_])
        np.testing.assert_allclose(g.numpy(), w,
                                   **_scaled(w, TOLS["float32"]),
                                   err_msg=name_)


# ---------------------------------------------------------------------------
# tests/test_moe.py's invariants, on the port


def _port(name="mixtral", **over):
    _, cfg = _cfgs(name, **over)
    return cfg, moe.moe_init(cfg, generator=torch.Generator().manual_seed(0))


def test_output_matches_dense_expert_computation():
    """With ample capacity, the dispatch/combine einsums equal the naive
    per-token top-k expert mixture."""
    cfg, p = _port(capacity=8.0)
    x = torch.from_numpy(_x(cfg, (2, 32)))
    with torch.no_grad():
        out, aux = moe.moe_apply(p, x, cfg)
        assert float(aux.dropped_frac) == 0.0
        xt = x.reshape(-1, cfg.d_model)
        probs = torch.softmax(xt @ p["router"], -1)
        topp, topi = moe.route(probs, cfg.num_experts_per_tok)
        topp = topp / topp.sum(-1, keepdim=True)
        ref = torch.zeros_like(xt)
        for e in range(cfg.num_experts):
            eo = ((xt @ p["wi"][e]) * torch.nn.functional.silu(
                xt @ p["wg"][e])) @ p["wo"][e]
            w = torch.where(topi == e, topp, 0.0).sum(-1)
            ref = ref + w[:, None] * eo
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=3e-3, atol=3e-3)


def test_capacity_drops_tokens():
    cfg, p = _port(capacity=0.25)
    with torch.no_grad():
        out, aux = moe.moe_apply(p, torch.from_numpy(_x(cfg, (4, 64), 2)),
                                 cfg)
    assert float(aux.dropped_frac) > 0.0
    assert bool(torch.isfinite(out).all())


def test_load_balance_loss_at_least_one():
    """Zero router weights give uniform probabilities; the Switch
    load-balance loss is then at least 1, its minimum."""
    cfg, p = _port(num_experts=4, num_experts_per_tok=1)
    with torch.no_grad():
        p["router"].zero_()
        _, aux = moe.moe_apply(p, torch.from_numpy(_x(cfg, (2, 64), 3)),
                               cfg)
    assert float(aux.load_balance) >= 1.0 - 1e-5


@pytest.mark.parametrize("seed,b", [(0, 1), (7, 2), (101, 4), (577, 2),
                                    (1000, 1)])
def test_router_gradients_finite(seed, b):
    _, cfg = _cfgs("mixtral")
    p = moe.moe_init(cfg, generator=torch.Generator().manual_seed(seed % 7))
    out, aux = moe.moe_apply(p, torch.from_numpy(_x(cfg, (b, 32), seed)),
                             cfg)
    loss = torch.sum(torch.square(out)) + aux.load_balance + aux.z_loss
    for g in torch.autograd.grad(loss, list(p.parameters())):
        assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# contracts


def test_group_size_contract_raises_like_the_reference():
    """B * S of 600 tokens is neither at most 512 nor a multiple of it:
    the reference asserts, the port raises ValueError."""
    jcfg, tcfg = _cfgs("granite")
    jp, tp = _params(jcfg)
    x = _x(tcfg, (2, 300))
    with pytest.raises(AssertionError):
        jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="groups of 512"):
        moe.moe_apply(tp, torch.from_numpy(x), tcfg)


def test_every_mixer_and_ffn_kind_builds_and_unknown_kinds_raise():
    """Every (mixer, ffn) kind of the registry's patterns builds a block in
    the port; an unknown mixer kind raises ValueError, as the reference's
    ``_mixer_init`` does, and so does an unknown FFN kind."""
    from repro_torch.configs import ARCHS, get_config
    # granite's experts and d_ff, zamba2's reduced SSM widths
    cfg = dataclasses.replace(get_reduced_config("granite-moe-1b-a400m"),
                              ssm_state=16, ssm_head_dim=32)
    mixers = {m for a in ARCHS for m, _ in get_config(a).block_pattern}
    ffns = {f for a in ARCHS for _, f in get_config(a).block_pattern}
    assert mixers == {"attn", "local_attn", "swa_attn", "xattn", "mamba",
                      "mlstm", "slstm"}
    pattern = tuple(zip(sorted(mixers), sorted(ffns) * 2))
    assert {f for _, f in pattern} == ffns
    block = blocks.block_init(cfg, generator=torch.Generator(),
                              pattern=pattern)
    assert [n for n, _ in block.named_children()] == [
        f"l{i}" for i in range(len(pattern))]
    with pytest.raises(ValueError, match="conv"):
        blocks.block_init(cfg, generator=torch.Generator(),
                          pattern=(("conv", "none"),))
    with pytest.raises(ValueError):
        blocks.block_init(cfg, generator=torch.Generator(),
                          pattern=(("attn", "relu"),))

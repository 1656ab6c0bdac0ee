"""The LM paths' losses against the JAX reference, float32 at 1e-5:
``chunked_logprob_entropy`` and ``chunked_softmax_xent`` (values and the
gradients with respect to the hidden states and the unembedding, with and
without the final softcap, one chunk and several), and
``impala_loss_from_logprobs`` (every output and the gradients with
respect to the log-probs, the entropy and the values, through the plain
V-trace loop and through the kernel's path: the JAX Pallas kernel in
interpret mode, the port's kernel wrapper on CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro_torch.core import losses as tlosses

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, V = 2, 16, 32, 64


def _head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    unembed = (rng.normal(0, 1, (D, V)) * D ** -0.5).astype(np.float32)
    actions = rng.integers(0, V, (B, S)).astype(np.int32)
    w_lp, w_ent = (rng.normal(0, 1, (B, S)).astype(np.float32)
                   for _ in range(2))
    return hidden, unembed, actions, w_lp, w_ent


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("softcap", [None, 3.0])
def test_chunked_logprob_entropy_values_and_grads(chunk, softcap):
    hidden, unembed, actions, w_lp, w_ent = _head_inputs()

    def jloss(h, u):
        lp, ent = jlosses.chunked_logprob_entropy(
            h, u, jnp.asarray(actions), chunk=chunk, final_softcap=softcap)
        return jnp.sum(w_lp * lp + w_ent * ent), (lp, ent)

    (jval, (jlp, jent)), (jdh, jdu) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(hidden),
                                              jnp.asarray(unembed))
    h = torch.tensor(hidden, requires_grad=True)
    u = torch.tensor(unembed, requires_grad=True)
    lp, ent = tlosses.chunked_logprob_entropy(
        h, u, torch.from_numpy(actions), chunk=chunk, final_softcap=softcap)
    val = torch.sum(torch.from_numpy(w_lp) * lp
                    + torch.from_numpy(w_ent) * ent)
    dh, du = torch.autograd.grad(val, (h, u))
    for name, got, want in [("logprob", lp, jlp), ("entropy", ent, jent),
                            ("value", val, jval), ("d hidden", dh, jdh),
                            ("d unembed", du, jdu)]:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    with torch.no_grad():       # the same values without autograd
        lp2, ent2 = tlosses.chunked_logprob_entropy(
            h, u, torch.from_numpy(actions), chunk=chunk,
            final_softcap=softcap)
    assert torch.equal(lp2, lp.detach()) and torch.equal(ent2, ent.detach())


@pytest.mark.parametrize("softcap", [None, 3.0])
def test_chunked_softmax_xent_values_and_grads(softcap):
    hidden, unembed, actions, _, _ = _head_inputs(seed=1)
    jval, (jdh, jdu) = jax.value_and_grad(
        lambda h, u: jlosses.chunked_softmax_xent(
            h, u, jnp.asarray(actions), chunk=8, final_softcap=softcap),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(unembed))
    h = torch.tensor(hidden, requires_grad=True)
    u = torch.tensor(unembed, requires_grad=True)
    val = tlosses.chunked_softmax_xent(h, u, torch.from_numpy(actions),
                                       chunk=8, final_softcap=softcap)
    dh, du = torch.autograd.grad(val, (h, u))
    np.testing.assert_allclose(val.item(), float(jval), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), **TOL)
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), **TOL)


def test_chunked_logprob_entropy_needs_a_dividing_chunk():
    hidden, unembed, actions, _, _ = _head_inputs()
    with pytest.raises(ValueError, match="divide"):
        tlosses.chunked_logprob_entropy(
            torch.from_numpy(hidden), torch.from_numpy(unembed),
            torch.from_numpy(actions), chunk=5)


def _rl_inputs(t=12, b=4, seed=2):
    rng = np.random.default_rng(seed)
    lp = -rng.random((t, b)).astype(np.float32) * 3
    return dict(
        target_logprobs=lp,
        target_entropy=rng.random((t, b)).astype(np.float32) * 2,
        behavior_logprobs=(lp + rng.normal(0, 0.3, (t, b))).astype(
            np.float32),
        rewards=rng.normal(0, 1, (t, b)).astype(np.float32),
        discounts=((rng.random((t, b)) > 0.1) * 0.99).astype(np.float32),
        values=rng.normal(0, 1, (t, b)).astype(np.float32),
        bootstrap_value=rng.normal(0, 1, (b,)).astype(np.float32))


@pytest.mark.parametrize("impl", ["scan", "kernel"])
def test_impala_loss_from_logprobs_outputs_and_grads(impl):
    x = _rl_inputs()
    kw = dict(baseline_cost=0.5, entropy_cost=0.003, clip_rho=1.0,
              clip_c=1.0, vtrace_impl=impl)
    diff = ("target_logprobs", "target_entropy", "values")

    def jloss(lp, ent, values):
        args = dict({k: jnp.asarray(v) for k, v in x.items()},
                    target_logprobs=lp, target_entropy=ent, values=values)
        out = jlosses.impala_loss_from_logprobs(**args, **kw)
        return out.total, out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x[k]) for k in diff))
    targs = {k: torch.tensor(v, requires_grad=k in diff)
             for k, v in x.items()}
    tout = tlosses.impala_loss_from_logprobs(**targs, **kw)
    tgrads = torch.autograd.grad(tout.total, [targs[k] for k in diff])
    for name in ("total", "pg_loss", "baseline_loss", "entropy_loss",
                 "vs_mean", "rho_mean", "priority"):
        np.testing.assert_allclose(
            getattr(tout, name).detach().numpy(),
            np.asarray(getattr(jout, name)), err_msg=name, **TOL)
    for name, got, want in zip(diff, tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"d {name}", **TOL)

"""The port's conv agents against the JAX agents with the same weights
(JAX init converted by ``repro_torch.convert``): forward outputs and
parameter gradients, the flatten order into the FC layer, the maxpool
geometry, the init distribution and the converter's round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import convnet as jconv
from repro_torch import convert
from repro_torch.models import convnet as tconv

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

NETS = {"minatar": (jconv.minatar_net, tconv.minatar_net),
        "deep": (jconv.impala_deep, tconv.impala_deep)}

CASES = [
    # net, obs_shape, actions, lead dims, grad tolerance
    ("minatar", (10, 5, 1), 3, (3, 2), 1e-5),     # Catch
    ("minatar", (10, 10, 4), 5, (3, 2), 1e-5),    # gridworld
    ("deep", (10, 5, 1), 3, (3, 2), 1e-5),
    ("deep", (10, 10, 4), 5, (3, 2), 1e-5),
    # Atari width, batch 2. Observed max abs grad error 1.5e-6 on the CPU
    # (largest grad 3.9): within 1e-5, so the 15 layers need no relaxation.
    ("deep", (84, 84, 4), 18, (2,), 1e-5),
]


def _pair(net, obs_shape, actions, seed=0):
    jnet, tnet = NETS[net]
    init_fn, apply_fn = jnet(obs_shape, actions)
    params, _ = jconv.init_agent(init_fn, jax.random.PRNGKey(seed))
    model = tnet(obs_shape, actions)
    model.load_state_dict(convert.state_dict_from_jax(params))
    return params, apply_fn, model


@pytest.mark.parametrize("net,obs_shape,actions,lead,tol", CASES)
def test_forward_and_grads_match_jax(net, obs_shape, actions, lead, tol):
    params, apply_fn, model = _pair(net, obs_shape, actions)
    rng = np.random.default_rng(1)
    obs = rng.random(lead + obs_shape).astype(np.float32)
    w_logits = rng.normal(0, 1, lead + (actions,)).astype(np.float32)
    w_base = rng.normal(0, 1, lead).astype(np.float32)

    def jloss(p):
        out = apply_fn(p, jnp.asarray(obs))
        return (jnp.sum(out.policy_logits * w_logits)
                + jnp.sum(out.baseline * w_base)), out

    jgrads, jout = jax.jit(jax.grad(jloss, has_aux=True))(params)
    tout = model(torch.from_numpy(obs))
    np.testing.assert_allclose(tout.policy_logits.detach().numpy(),
                               jout.policy_logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.baseline.detach().numpy(),
                               jout.baseline, rtol=1e-5, atol=1e-5)

    loss = (torch.sum(tout.policy_logits * torch.from_numpy(w_logits))
            + torch.sum(tout.baseline * torch.from_numpy(w_base)))
    loss.backward()
    tgrads = convert.state_dict_to_jax(
        {name: p.grad for name, p in model.named_parameters()})
    got = jax.tree.leaves(tgrads)
    want = jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


def test_maxpool_geometry_catch():
    """window 3 / stride 2 / pad 1 gives ceil(H/2): 10x5 -> 5x3 -> 3x2 -> 2x1,
    so the FC layer sees 2*1*32 inputs, as in the JAX init."""
    params, _, model = _pair("deep", (10, 5, 1), 3)
    assert model.fc.in_features == 2 * 1 * 32
    assert model.fc.in_features == params["fc"]["w"].shape[0]


def test_converter_round_trip():
    params, _, model = _pair("deep", (10, 10, 4), 5)
    back = convert.state_dict_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_init_distribution():
    """Truncated normal on +-2 sigma, scaled 1/sqrt(fan_in); heads 0.01."""
    model = tconv.impala_deep((84, 84, 4), 18,
                              generator=torch.Generator().manual_seed(3))
    std_unit = 0.8796   # std of a standard normal truncated to [-2, 2]
    for layer, fan_in, scale in [
            (model.sections[1].res[0].c1, 9 * 32, None),
            (model.fc, model.fc.in_features, None),
            (model.policy, 256, 0.01)]:
        scale = scale or 1.0 / np.sqrt(fan_in)
        w = layer.weight.detach().numpy() / scale
        assert np.abs(w).max() <= 2.0 + 1e-5
        assert abs(w.std() - std_unit) < 0.05 * std_unit + 3 / np.sqrt(w.size)
        assert not layer.bias.detach().any()


def test_generator_makes_init_reproducible():
    a = tconv.minatar_net((10, 5, 1), 3,
                          generator=torch.Generator().manual_seed(7))
    b = tconv.minatar_net((10, 5, 1), 3,
                          generator=torch.Generator().manual_seed(7))
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)

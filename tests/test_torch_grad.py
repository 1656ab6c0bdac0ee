"""Gradients of the port's kernel paths.

On the CPU: ``attn_apply(impl="kernel")`` and ``mamba_apply(impl="kernel")``
against ``jax.value_and_grad`` of the reference's own kernel path (its
Pallas kernels in interpret mode, backward the VJP of its plain versions),
with the weights carried across by ``convert.py``; and whole-model forward
and backward of the reduced ``qwen3-4b`` and ``zamba2-2.7b``, kernel path
against plain path, as ``tests/test_attn_impl.py::
test_model_fwd_bwd_kernel_parity`` holds the reference. All at that file's
float32 bar.

On the card (``gpu``, skipped without one): the same gradients through the
CUDA kernels against the plain paths, and the raw CUDA wrappers refusing an
input that requires grad. JAX is imported only by the CPU cases (the
``jx`` fixture), so the ``gpu`` cases run where only PyTorch for CUDA is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_grad.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.convert import lm_state_dict_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA
from repro_torch.models import mamba as TM
from repro_torch.models import model as tmodel

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_attn_impl.py's bar

ATTN_VARIANTS = [
    ("attn", None, 2),        # GQA
    ("attn", None, 1),        # MQA
    ("attn", 30.0, 2),        # softcap
    ("swa_attn", None, 2),    # sliding window
]
# (S, with a state): one 16-token chunk, two chunks with the state carried
# through the kernel, each from zeros and from a given state
MAMBA_CASES = [(16, False), (32, False), (16, True), (32, True)]


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's modules, imported here and not at the top, so
    that the ``gpu`` cases run without JAX."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jax_reduced_config
    from repro.models import attention as JA
    from repro.models import mamba as JM
    from repro.models.common import split_params
    return types.SimpleNamespace(jax=jax, jnp=jnp, JA=JA, JM=JM,
                                 config=jax_reduced_config,
                                 split_params=split_params)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return resolve_device("cuda")


def _attn_cfg(kind, softcap, kv_heads):
    return dict(attn_logit_softcap=softcap, sliding_window=48, attn_chunk=32,
                num_kv_heads=kv_heads)


def _x(d_model, b, s, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(
        0, 1, (b, s, d_model))).astype(np.float32)


def _assert_grads(module, want):
    """Every parameter's grad against ``want``, a state_dict of grads."""
    got = {name: p.grad for name, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.detach().cpu().numpy(),
                                   want[name].numpy(), **TOL, err_msg=name)


def _torch_attn(params, x, cfg, kind, impl):
    """mean(out^2) of attn_apply and its output; grads land on x and the
    parameters."""
    pos = torch.arange(x.shape[1], device=x.device)
    out, _ = TA.attn_apply(params, x, cfg=cfg, kind=kind, positions=pos,
                           impl=impl)
    loss = torch.mean(torch.square(out.float()))
    loss.backward()
    return loss, out


# ---------------------------------------------------------------------------
# CPU: the kernel paths against jax.value_and_grad of the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,softcap,kv_heads", ATTN_VARIANTS)
def test_attn_kernel_grad_matches_jax(jx, kind, softcap, kv_heads):
    over = _attn_cfg(kind, softcap, kv_heads)
    jcfg = dataclasses.replace(jx.config("qwen3-32b"), **over)
    tcfg = dataclasses.replace(get_reduced_config("qwen3-32b"), **over)
    jp = jx.split_params(jx.JA.attn_init(jx.jax.random.PRNGKey(0), jcfg,
                                         kind))[0]
    tp = TA.attn_init(tcfg, kind, generator=torch.Generator())
    tp.load_state_dict(lm_state_dict_from_jax(jp), strict=True)
    x = _x(jcfg.d_model, 2, 96, seed=kv_heads)

    def loss_fn(params, xj):
        o, _ = jx.JA.attn_apply(params, xj, cfg=jcfg, kind=kind,
                                positions=jx.jnp.arange(96), impl="kernel")
        return jx.jnp.mean(jx.jnp.square(o)), o

    (want_loss, want_o), (want_gp, want_gx) = jx.jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jp, jx.jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss, out = _torch_attn(tp, xt, tcfg, kind, "kernel")
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), want_o, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)
    _assert_grads(tp, lm_state_dict_from_jax(want_gp))


def _mamba_state(cfg, b, seed):
    """A non-zero incoming state {conv, ssm}, float32."""
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    rng = np.random.default_rng(seed)
    return {"conv": (0.5 * rng.normal(0, 1, (b, cfg.ssm_conv_width - 1,
                                             d_in + 2 * cfg.ssm_state))
                     ).astype(np.float32),
            "ssm": (0.5 * rng.normal(0, 1, (b, nh, cfg.ssm_head_dim,
                                            cfg.ssm_state))
                    ).astype(np.float32)}


def _mamba_loss(y, st, mean, square):
    """mean(y^2), plus mean(h^2) of the outgoing state when there is one."""
    loss = mean(square(y))
    return loss if st is None else loss + mean(square(st["ssm"]))


@pytest.mark.parametrize("s,with_state", MAMBA_CASES)
def test_mamba_kernel_grad_matches_jax(jx, s, with_state):
    jcfg = jx.config("zamba2-2.7b")
    tcfg = get_reduced_config("zamba2-2.7b")
    jp = jx.split_params(jx.JM.mamba_init(jx.jax.random.PRNGKey(0),
                                          jcfg))[0]
    tp = TM.mamba_init(tcfg, generator=torch.Generator())
    tp.load_state_dict(lm_state_dict_from_jax(jp), strict=True)
    x = _x(jcfg.d_model, 2, s, seed=s, scale=0.5)
    st = _mamba_state(tcfg, 2, seed=s + 1) if with_state else None

    def loss_fn(params, xj, state):
        y, new = jx.JM.mamba_apply(params, xj, jcfg, state=state,
                                   return_state=with_state, impl="kernel")
        return _mamba_loss(y, new, jx.jnp.mean, jx.jnp.square), y

    jst = None if st is None else {k: jx.jnp.asarray(v)
                                   for k, v in st.items()}
    (want_loss, want_y), grads = jx.jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(jp, jx.jnp.asarray(x), jst)
    want_gp, want_gx, want_gst = grads

    xt = torch.from_numpy(x).requires_grad_()
    tst = None if st is None else {k: torch.from_numpy(v).requires_grad_()
                                   for k, v in st.items()}
    y, new = TM.mamba_apply(tp, xt, tcfg, state=tst,
                            return_state=with_state, impl="kernel")
    loss = _mamba_loss(y, new, torch.mean, torch.square)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, **TOL)
    if with_state:
        for leaf in ("conv", "ssm"):
            np.testing.assert_allclose(tst[leaf].grad.numpy(),
                                       want_gst[leaf], **TOL, err_msg=leaf)
    _assert_grads(tp, lm_state_dict_from_jax(want_gp))


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_model_fwd_bwd_kernel_parity(arch):
    """The reduced decoder's forward and backward through the kernel paths
    (flash attention, SSD chunk) against the plain paths, every parameter's
    grad included, as the reference's own test holds its kernel path."""
    base = get_reduced_config(arch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (2, 32)))
    out = {}
    for impl in ("xla", "kernel"):
        cfg = dataclasses.replace(base, attn_impl=impl, ssd_impl=impl)
        params = tmodel.init(cfg, seed=0)
        h, _, _ = tmodel.forward(params, tokens, cfg=cfg, impl=impl)
        loss = torch.mean(torch.square(h.float()))
        loss.backward()
        out[impl] = loss, {n: p.grad for n, p in params.named_parameters()}
    (want, want_g), (got, got_g) = out["xla"], out["kernel"]
    torch.testing.assert_close(got, want, **TOL)
    assert got_g.keys() == want_g.keys()
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], **TOL,
                                   msg=name)


def test_trainable_wrappers_leave_no_grad_behind_on_the_cpu():
    """On CPU tensors the raw wrappers are the plain versions, and so carry
    autograd history themselves: only CUDA launches refuse grad."""
    q = torch.randn((1, 2, 8, 64), requires_grad=True)
    assert tops.flash_attention(q, q[:, :1], q[:, :1]).requires_grad
    args = [torch.randn(s, requires_grad=True) for s in
            [(2, 8, 16), (2, 8, 16), (2, 8, 32), (2, 8, 1), (2, 32, 16)]]
    y, h_new = tops.ssd_chunk_trainable(*args)
    (y.square().mean() + h_new.square().mean()).backward()
    assert all(a.grad is not None for a in args)


def _steep_decay_chunk(seed=0, bsz=2, l=64, heads=3, p=32, n=16):
    """One SSD chunk in the model's layout whose decay passes the point
    where exp overflows float32: acs falls to about -100 over the chunk,
    as it does over a full-width Zamba2 chunk of 256 tokens (-89.7 at
    seed 0 of a Mamba2 layer; the chip's phase 16)."""
    rng = np.random.default_rng(seed)
    c, b = (rng.normal(0, 1, (bsz, l, n)).astype(np.float32)
            for _ in range(2))
    xdt = rng.normal(0, 1, (bsz, l, heads, p)).astype(np.float32)
    da = -rng.uniform(1.2, 2.0, (bsz, l, heads)).astype(np.float32)
    h = rng.normal(0, 1, (bsz, heads, p, n)).astype(np.float32)
    return c, b, xdt, da, h


def test_ssd_chunk_grad_stays_finite_past_exp_overflow(jx):
    """The SSD chunk's backward (the VJP of its plain version) at a decay
    whose segment sums above the diagonal overflow exp: the port's
    gradient is finite and equals the plain einsum path's (masked before
    the exp, as the reference's ``mamba._segsum``) within 1e-5, where the
    reference's ``kernels/ref.py::ref_ssd_chunk`` masks after the exp and
    its VJP is inf * 0 = NaN (ROADMAP.md §3 records the fault)."""
    inputs = _steep_decay_chunk()
    assert np.cumsum(inputs[3], axis=1).min() < -89.0
    grads = {}
    for name, fn in (("kernel", tops.ssd_chunk_trainable),
                     ("xla", TM._chunk_xla)):
        args = [torch.tensor(a, requires_grad=True) for a in inputs]
        y, h_new = fn(*args)
        (y.square().mean() + h_new.square().mean()).backward()
        grads[name] = [a.grad for a in args]
    for i, (g, w) in enumerate(zip(grads["kernel"], grads["xla"])):
        assert torch.isfinite(g).all(), i
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=str(i),
                                   **TOL)

    from repro.kernels import ref as jref
    jnp = jx.jnp
    c, b, xdt, da, h = inputs
    rows = c.shape[0] * xdt.shape[2]

    def loss(*args):      # the reference's slice layout of the same chunk
        y, h_new = jref.ref_ssd_chunk(*args)
        return jnp.mean(jnp.square(y)) + jnp.mean(jnp.square(h_new))

    per_head = [np.repeat(t, xdt.shape[2], axis=0) for t in (c, b)]
    jgrads = jx.jax.grad(loss, argnums=3)(
        *(jnp.asarray(t) for t in per_head),
        jnp.asarray(xdt.transpose(0, 2, 1, 3).reshape(rows, -1, xdt.shape[3])),
        jnp.asarray(da.transpose(0, 2, 1).reshape(rows, -1, 1)),
        jnp.asarray(h.reshape(rows, h.shape[2], h.shape[3])))
    assert not np.isfinite(np.asarray(jgrads)).all()


# ---------------------------------------------------------------------------
# the card: gradients through the CUDA kernels, and the raw wrappers' refusal
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("kind,softcap,kv_heads", ATTN_VARIANTS)
def test_attn_kernel_grad_on_the_card(cuda_device, kind, softcap, kv_heads):
    """attn_apply(impl="kernel") on CUDA, float32: the flash-attention
    kernel forward, the chunked plain path backward, against the dense
    plain path, at 1e-5 on the output, x and every parameter."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-32b"),
                              **_attn_cfg(kind, softcap, kv_heads))
    gen = torch.Generator().manual_seed(0)
    base = TA.attn_init(cfg, kind, generator=gen)
    x = torch.from_numpy(_x(cfg.d_model, 2, 96, seed=kv_heads))
    runs = {}
    for impl in ("xla", "kernel"):
        params = TA.attn_init(cfg, kind, generator=gen).to(cuda_device)
        params.load_state_dict(base.state_dict())
        xt = x.to(cuda_device).requires_grad_()
        before = tops.stats()["flash_attention"]
        loss, out = _torch_attn(params, xt, cfg, kind, impl)
        assert tops.stats()["flash_attention"] - before == (impl == "kernel")
        runs[impl] = out, xt.grad, {n: p.grad for n, p in
                                    params.named_parameters()}
    (want, want_gx, want_g), (got, got_gx, got_g) = runs["xla"], \
        runs["kernel"]
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_gx, want_gx, **TOL)
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], **TOL,
                                   msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("s,with_state", MAMBA_CASES)
def test_mamba_kernel_grad_on_the_card(cuda_device, s, with_state):
    """mamba_apply(impl="kernel") on CUDA, float32: the SSD chunk kernel
    forward (one launch a chunk), the plain version's VJP backward, against
    the plain path, at 1e-5 on the output, x, the state and every
    parameter."""
    cfg = get_reduced_config("zamba2-2.7b")
    gen = torch.Generator().manual_seed(0)
    base = TM.mamba_init(cfg, generator=gen)
    x = torch.from_numpy(_x(cfg.d_model, 2, s, seed=s, scale=0.5))
    st = _mamba_state(cfg, 2, seed=s + 1) if with_state else None
    runs = {}
    for impl in ("xla", "kernel"):
        params = TM.mamba_init(cfg, generator=gen).to(cuda_device)
        params.load_state_dict(base.state_dict())
        xt = x.to(cuda_device).requires_grad_()
        tst = None if st is None else {
            k: torch.from_numpy(v).to(cuda_device).requires_grad_()
            for k, v in st.items()}
        before = tops.stats()["ssd_chunk"]
        y, new = TM.mamba_apply(params, xt, cfg, state=tst,
                                return_state=with_state, impl=impl)
        _mamba_loss(y, new, torch.mean, torch.square).backward()
        launches = tops.stats()["ssd_chunk"] - before
        assert launches == (impl == "kernel") * s // cfg.ssm_chunk
        runs[impl] = (y, xt.grad,
                      None if tst is None else [tst[k].grad for k in tst],
                      {n: p.grad for n, p in params.named_parameters()})
    (want, want_gx, want_gs, want_g), (got, got_gx, got_gs, got_g) = \
        runs["xla"], runs["kernel"]
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got_gx, want_gx, **TOL)
    if with_state:
        for g, w in zip(got_gs, want_gs):
            torch.testing.assert_close(g, w, **TOL)
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], **TOL,
                                   msg=name)


@pytest.mark.gpu
def test_raw_cuda_wrappers_refuse_an_input_that_requires_grad(cuda_device):
    """The raw wrappers have no backward: on CUDA, with grad mode on and an
    input that requires grad, each raises instead of returning an output
    with no history; under no_grad the same call launches."""
    def dev(*shape):
        return torch.randn(shape, device=cuda_device)

    q, kv = dev(1, 4, 8, 64), dev(1, 2, 8, 64)
    ssd = [dev(2, 8, 16), dev(2, 8, 16), dev(2, 8, 32),
           -torch.rand((2, 8, 1), device=cuda_device), dev(2, 32, 16)]
    slot = torch.arange(8, dtype=torch.int32, device=cuda_device)
    calls = {
        "flash_attention": lambda x: tops.flash_attention(x, kv, kv),
        "decode_attention": lambda x: tops.decode_attention(
            x[:, :, 0], kv, kv, slot, 7),
        "ssd_chunk": lambda x: tops.ssd_chunk(*ssd[:2], x, *ssd[3:]),
    }
    inputs = {"flash_attention": q, "decode_attention": q,
              "ssd_chunk": ssd[2]}
    for name, call in calls.items():
        x = inputs[name].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            call(x)
        with torch.no_grad():
            before = tops.stats()[name]
            call(x)
            assert tops.stats()[name] == before + 1

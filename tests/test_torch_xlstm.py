"""The port's xLSTM mixers against the JAX reference (``repro.models.xlstm``):
``mlstm_apply`` with and without a carried state over one and several
chunks, ``mlstm_decode``, the sequential oracle ``mlstm_reference``,
``slstm_apply`` and ``slstm_decode``, from the same numpy-seeded weights
and inputs; then the reference's own properties (tests/test_recurrent.py)
on the port, a bf16 forward whose state stays float32, and the length
contract (the reference asserts, the port raises ValueError).

Tolerance: float32 at 1e-5 (tests/test_attn_impl.py's bar); the
reference's property tests keep their own 2e-4 / 1e-3; bf16 at
tests/test_torch_model.py's 6e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xlstm as jx
from repro.models.common import split_params
from repro_torch import configs as tconfigs
from repro_torch.models import blocks
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as tx

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0, atol=6e-2)
ARCH = "xlstm-125m"


def _cfgs(**over):
    return (dataclasses.replace(jconfigs.get_reduced_config(ARCH), **over),
            dataclasses.replace(tconfigs.get_reduced_config(ARCH), **over))


def _params(kind, jcfg, tcfg, seed=0):
    """The reference's layer params from a JAX key and the port's layer
    holding the same values."""
    init = {"mlstm": (jx.mlstm_init, tx.mlstm_init),
            "slstm": (jx.slstm_init, tx.slstm_init)}[kind]
    jp = split_params(init[0](jax.random.PRNGKey(seed), jcfg))[0]
    tp = init[1](tcfg, generator=torch.Generator().manual_seed(seed))
    tp.load_state_dict({k: torch.tensor(np.asarray(v))
                        for k, v in jp.items()}, strict=True)
    return jp, tp


def _x(cfg, shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).normal(
        0, 1, shape + (cfg.d_model,))).astype(np.float32)


def _state(kind, cfg, b, seed):
    """A carried state drawn from numpy: the stabiliser m at moderate
    values, the normaliser n positive in sLSTM."""
    rng = np.random.default_rng(seed)
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    if kind == "mlstm":
        st = {"C": rng.normal(0, 1, (b, h, dh, dh)),
              "n": rng.normal(0, 1, (b, h, dh)),
              "m": rng.normal(0, 1, (b, h))}
    else:
        st = {"c": rng.normal(0, 1, (b, h, dh)),
              "n": rng.uniform(0.5, 2.0, (b, h, dh)),
              "h": rng.normal(0, 0.5, (b, h, dh)),
              "m": rng.normal(0, 1, (b, h, dh))}
    return {k: v.astype(np.float32) for k, v in st.items()}


def _both(st):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol,
                               err_msg=msg)


def _close_state(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        _close(got[k], want[k], tol, k)


# ---------------------------------------------------------------------------
# each mixer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("seq", [8, 16, 48])
def test_mlstm_apply_matches_jax(seq, carried):
    """Shorter than a chunk (one chunk of 8), one chunk, three chunks
    (the state carried through two chunk boundaries), from zeros or from
    a carried state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("mlstm", jcfg, tcfg)
    x = _x(tcfg, (2, seq))
    jst, tst = _both(_state("mlstm", tcfg, 2, 7)) if carried else (None,
                                                                  None)
    want, want_st = jx.mlstm_apply(jp, jnp.asarray(x), jcfg, state=jst,
                                   return_state=True)
    with torch.no_grad():
        got, got_st = tx.mlstm_apply(tp, torch.from_numpy(x), tcfg,
                                     state=tst, return_state=True)
    _close(got, want)
    _close_state(got_st, want_st)


def test_mlstm_decode_matches_jax():
    """Six decode steps from a carried state, the state written in place
    into the dict given."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("mlstm", jcfg, tcfg)
    x = _x(tcfg, (2, 6), seed=2)
    jst, tst = _both(_state("mlstm", tcfg, 2, 8))
    for t in range(6):
        want, jst = jx.mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                    jcfg)
        with torch.no_grad():
            got, st = tx.mlstm_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tst, tcfg)
        assert st is tst
        _close(got, want)
        _close_state(tst, jst)


def test_mlstm_reference_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("mlstm", jcfg, tcfg)
    x = _x(tcfg, (2, 10), seed=3)
    jst, tst = _both(_state("mlstm", tcfg, 2, 9))
    want, want_st = jx.mlstm_reference(jp, jnp.asarray(x), jcfg, state=jst)
    kept = {k: v.clone() for k, v in tst.items()}
    with torch.no_grad():
        got, got_st = tx.mlstm_reference(tp, torch.from_numpy(x), tcfg,
                                         state=tst)
    _close(got, want)
    _close_state(got_st, want_st)
    for k in kept:                  # the oracle works on a copy
        assert torch.equal(tst[k], kept[k])


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_apply_matches_jax(carried):
    jcfg, tcfg = _cfgs()
    jp, tp = _params("slstm", jcfg, tcfg)
    x = _x(tcfg, (2, 12), seed=4)
    jst, tst = _both(_state("slstm", tcfg, 2, 10)) if carried else (None,
                                                                   None)
    want, want_st = jx.slstm_apply(jp, jnp.asarray(x), jcfg, state=jst,
                                   return_state=True)
    with torch.no_grad():
        got, got_st = tx.slstm_apply(tp, torch.from_numpy(x), tcfg,
                                     state=tst, return_state=True)
    _close(got, want)
    _close_state(got_st, want_st)


def test_slstm_decode_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params("slstm", jcfg, tcfg)
    x = _x(tcfg, (2, 6), seed=5)
    jst, tst = _both(_state("slstm", tcfg, 2, 11))
    for t in range(6):
        want, jst = jx.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                    jcfg)
        with torch.no_grad():
            got, st = tx.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tst, tcfg)
        assert st is tst
        _close(got, want)
        _close_state(tst, jst)


def test_mixer_gradients_match_jax():
    """The gradient of mean(out^2) through a (mLSTM, sLSTM) pair, on the
    input and every weight, against ``jax.grad`` (two mLSTM chunks)."""
    jcfg, tcfg = _cfgs()
    jm, tm = _params("mlstm", jcfg, tcfg)
    js, ts = _params("slstm", jcfg, tcfg, seed=1)
    x = _x(tcfg, (2, 32), seed=6)

    def jloss(pm, ps, x):
        y, _ = jx.mlstm_apply(pm, x, jcfg)
        y, _ = jx.slstm_apply(ps, y, jcfg)
        return jnp.mean(jnp.square(y))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jm, js, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = tx.mlstm_apply(tm, xt, tcfg)
    y, _ = tx.slstm_apply(ts, y, tcfg)
    torch.mean(torch.square(y)).backward()
    _close(xt.grad, want[2], msg="x")
    for tp, wp in ((tm, want[0]), (ts, want[1])):
        for name, p in tp.named_parameters():
            scale = float(np.abs(np.asarray(wp[name])).max())
            np.testing.assert_allclose(p.grad.numpy(), wp[name], rtol=1e-5,
                                       atol=1e-5 * max(scale, 1.0),
                                       err_msg=name)


# ---------------------------------------------------------------------------
# the reference's properties on the port
# ---------------------------------------------------------------------------

def test_mlstm_chunked_matches_sequential_reference():
    _, cfg = _cfgs(xlstm_chunk=8)
    p = tx.mlstm_init(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(cfg, (2, 24), seed=12))
    with torch.no_grad():
        y_chunk, st = tx.mlstm_apply(p, x, cfg, return_state=True)
        y_ref, st_ref = tx.mlstm_reference(p, x, cfg)
    torch.testing.assert_close(y_chunk, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st["C"], st_ref["C"], rtol=2e-4, atol=2e-4)


def test_mlstm_forget_gate_decays_state():
    """With very negative forget pre-activations old inputs must not leak:
    the last output depends only on recent inputs."""
    _, cfg = _cfgs(xlstm_chunk=4)
    p = tx.mlstm_init(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        p["bf"].fill_(-20.0)
        x = torch.from_numpy(_x(cfg, (1, 16), seed=13, scale=1.0))
        x2 = x.clone()
        x2[:, :8] = torch.from_numpy(_x(cfg, (1, 8), seed=14, scale=1.0))
        y1, _ = tx.mlstm_apply(p, x, cfg)
        y2, _ = tx.mlstm_apply(p, x2, cfg)
    torch.testing.assert_close(y1[:, -1], y2[:, -1], rtol=1e-3, atol=1e-3)


def test_slstm_apply_matches_decode_loop():
    _, cfg = _cfgs()
    p = tx.slstm_init(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(cfg, (2, 12), seed=15))
    state = tx.slstm_state_init(cfg, 2)
    with torch.no_grad():
        y_full, st = tx.slstm_apply(p, x, cfg, return_state=True)
        ys = [tx.slstm_decode(p, x[:, t:t + 1], state, cfg)[0]
              for t in range(12)]
    torch.testing.assert_close(y_full, torch.cat(ys, 1), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(st["h"], state["h"], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# precision and contracts
# ---------------------------------------------------------------------------

def test_bf16_forward_keeps_float32_state_and_matches_jax():
    """bf16 activations: both mixers' outputs in bf16 within the bf16 bar
    of the reference's, their states float32 (mixer, block cache, model
    cache and prefill cache)."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    x = _x(tcfg, (2, 32), seed=16)
    for kind in ("mlstm", "slstm"):
        jp, tp = _params(kind, jcfg, tcfg)
        want, want_st = getattr(jx, f"{kind}_apply")(
            jp, jnp.asarray(x, jnp.bfloat16), jcfg, return_state=True)
        with torch.no_grad():
            got, got_st = getattr(tx, f"{kind}_apply")(
                tp, torch.from_numpy(x).bfloat16(), tcfg, return_state=True)
        assert got.dtype == torch.bfloat16
        _close(got, want, BF16_TOL, kind)
        _close_state(got_st, want_st, BF16_TOL)
    for leaf in blocks.block_cache_init(tcfg, 2, 8, torch.bfloat16).values():
        assert all(v.dtype == torch.float32 for v in leaf.values())
    params = tmodel.init(tcfg, seed=0)
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        h, _, cache = tmodel.prefill(params, tokens, cfg=tcfg,
                                     cache_seq_len=24)
    assert h.dtype == torch.bfloat16
    for tree in (cache, tmodel.cache_init(tcfg, 2, 24)):
        for layer in tree["block"].values():
            assert all(v.dtype == torch.float32 for v in layer.values())


def test_unsupported_length_raises_value_error():
    """24 tokens at chunk 16: over one chunk and not a multiple of it. The
    reference asserts; the port raises ValueError, in the mixer and in
    the model."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params("mlstm", jcfg, tcfg)
    x = _x(tcfg, (1, 24))
    with pytest.raises(AssertionError):
        jx.mlstm_apply(jp, jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="multiple"):
        tx.mlstm_apply(tp, torch.from_numpy(x), tcfg)
    with pytest.raises(ValueError, match="multiple"):
        tmodel.apply_lm(tmodel.init(tcfg, seed=0),
                        torch.zeros((1, 24), dtype=torch.int64), cfg=tcfg)

"""The port's DecodeSession and continuous-batching server: the guarantees
of tests/test_decode_session.py, inside the port and bitwise where that
file is bitwise —
  * a single-request server equals ``generate`` with the same seed,
  * admission and eviction of neighbours never perturb a surviving slot,
  * a recycled slot leaks no KV, position or generator state,
  * per-request max_tokens / temperature / stop_token are honoured,
and batched admission, the server's thread and failure handling, and the
serve CLI on the CPU; for the reduced Zamba2 hybrid too (Mamba2 conv and
ssm state in the slot's cache row, the shared block's KV), whose session
is also held against the JAX ``DecodeSession`` by teacher forcing; for
the reduced Granite MoE, whose capacity 4.0 is dropless, so that a token's
experts never depend on its neighbours in the batch; and for the reduced
xLSTM (the mLSTM and sLSTM states in the slot's cache row, float32),
teacher-forced against the JAX session too."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import generate as G
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models import model as model_lib

# The suite runs several test processes side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

P, N = 4, 8   # prompt length (on the bucket ladder), generation budget
SEED = 7


@pytest.fixture(scope="module",
                params=["qwen3-4b", "gemma2-27b", "zamba2-2.7b",
                        "granite-moe-1b-a400m", "xlstm-125m"])
def setup(request):
    return _setup(request.param)


def _setup(arch):
    """The reduced ``arch``'s config, weights from seed 0, a prompt and
    ``generate``'s stream from it: the per-request tests' input."""
    cfg = get_reduced_config(arch)
    params = model_lib.init(cfg, seed=0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, P))
    ref = {k: v.numpy() for k, v in G.generate(
        params, prompt, SEED, cfg=cfg, num_steps=N).items()}
    return cfg, params, prompt, ref


def _run_session(sess, slot, prompt, seed, n):
    out0 = sess.prefill_into(slot, prompt, seed=seed)
    toks, lps = [out0["token"]], [out0["logprob"]]
    for _ in range(n - 1):
        o = sess.step()
        toks.append(o["token"][slot])
        lps.append(o["logprob"][slot])
    return np.asarray(toks), np.asarray(lps)


def test_generate_shapes(setup):
    cfg, params, prompt, ref = setup
    assert ref["tokens"].shape == (1, P + N)
    np.testing.assert_array_equal(ref["tokens"][:, :P], prompt)
    for key in ("logprob", "entropy", "baseline"):
        assert ref[key].shape == (1, N) and np.isfinite(ref[key]).all()
    assert (ref["logprob"] <= 0).all()
    assert (ref["entropy"] <= np.log(cfg.vocab_size) + 1e-4).all()


def test_single_request_bitwise_parity_with_generate(setup):
    """Server (max_batch=1) vs generate(): identical tokens, bitwise —
    both run the same session functions."""
    cfg, params, prompt, ref = setup
    server = Server(cfg, params, max_batch=1, max_len=P + N).start()
    try:
        tokens = server.submit(prompt[0], max_tokens=N,
                               seed=SEED).result(timeout=300)
    finally:
        server.stop()
    np.testing.assert_array_equal(tokens, ref["tokens"][0])


def test_admission_eviction_preserves_survivors(setup):
    """A slot's stream is a function of its own (prompt, seed): bitwise
    equal to the same slot decoding alone in a session of the same shape,
    while neighbours are admitted, evicted and re-admitted around it."""
    cfg, params, prompt, ref = setup
    solo = G.DecodeSession(params, cfg, max_batch=4, max_len=P + N)
    want_t, want_lp = _run_session(solo, 2, prompt[0], SEED, N)

    sess = G.DecodeSession(params, cfg, max_batch=4, max_len=P + N)
    rng = np.random.default_rng(0)
    out0 = sess.prefill_into(2, prompt[0], seed=SEED)
    toks, lps = [out0["token"]], [out0["logprob"]]
    sess.prefill_into(0, rng.integers(0, cfg.vocab_size, size=3), seed=11,
                      temperature=0.7)
    for i in range(N - 1):
        if i == 2:
            sess.evict(0)
        if i == 4:   # recycle the freed slot mid-flight
            sess.prefill_into(0, rng.integers(0, cfg.vocab_size, size=2),
                              seed=13)
        o = sess.step()
        toks.append(o["token"][2])
        lps.append(o["logprob"][2])
    np.testing.assert_array_equal(np.asarray(toks), want_t)
    np.testing.assert_array_equal(np.asarray(lps), want_lp)
    np.testing.assert_array_equal(np.asarray(toks), ref["tokens"][0, P:])


def test_slot_recycling_never_leaks_kv(setup):
    """Tenant B in a recycled slot decodes exactly as in a fresh session:
    nothing of tenant A's KV, position or generator state survives."""
    cfg, params, prompt, ref = setup
    prompt_b = np.random.default_rng(22).integers(0, cfg.vocab_size, (P,))
    fresh = G.DecodeSession(params, cfg, max_batch=1, max_len=P + N)
    want_t, want_lp = _run_session(fresh, 0, prompt_b, 21, N)

    recycled = G.DecodeSession(params, cfg, max_batch=1, max_len=P + N)
    _run_session(recycled, 0, prompt[0], SEED, N)
    recycled.evict(0)
    got_t, got_lp = _run_session(recycled, 0, prompt_b, 21, N)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_lp, want_lp)


def test_per_request_budget_and_stop_token(setup):
    """max_tokens truncates to a prefix of the full stream; stop_token ends
    the request the moment it is sampled (stop included in the result)."""
    cfg, params, prompt, ref = setup
    full = ref["tokens"][0, P:]
    stop = int(full[2])
    server = Server(cfg, params, max_batch=2, max_len=P + N).start()
    try:
        h_budget = server.submit(prompt[0], max_tokens=3, seed=SEED)
        h_stop = server.submit(prompt[0], max_tokens=N, stop_token=stop,
                               seed=SEED)
        np.testing.assert_array_equal(h_budget.result(timeout=300)[P:],
                                      full[:3])
        got = h_stop.result(timeout=300)[P:]
        first_stop = int(np.flatnonzero(full == stop)[0])
        np.testing.assert_array_equal(got, full[:first_stop + 1])
    finally:
        server.stop()


def test_static_and_continuous_agree_per_request():
    """Streams are request-local, so the scheduling policy must not change
    any request's tokens, only the step count."""
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(1, 6)))
               for _ in range(5)]
    budgets = [1 + i for i in range(5)]

    def run(policy):
        server = Server(cfg, params, max_batch=2, max_len=16,
                        policy=policy).start()
        try:
            hs = [server.submit(p, max_tokens=n, seed=100 + i)
                  for i, (p, n) in enumerate(zip(prompts, budgets))]
            return [h.result(timeout=300) for h in hs], server.steps
        finally:
            server.stop()

    cont, cont_steps = run("continuous")
    stat, stat_steps = run("static")
    for a, b in zip(cont, stat):
        np.testing.assert_array_equal(a, b)
    assert cont_steps <= stat_steps


def test_temperature_changes_stream_deterministically():
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (P,))

    def run(temp):
        sess = G.DecodeSession(params, cfg, max_batch=1, max_len=P + N)
        out0 = sess.prefill_into(0, prompt, seed=5, temperature=temp)
        toks = [out0["token"]]
        for _ in range(N - 1):
            toks.append(sess.step()["token"][0])
        return np.asarray(toks)

    np.testing.assert_array_equal(run(0.5), run(0.5))
    # near-greedy vs hot sampling must diverge for an untrained model
    assert not np.array_equal(run(0.05), run(5.0))


def test_prefill_many_matches_prefill_into():
    """Batched admission gives the per-slot state and first tokens of
    sequential prefill_into calls (up to the float rounding of a larger
    batch), grouping mixed prompt lengths by bucket."""
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    prompts = [np.array([3, 5, 7]), np.array([11]), np.array([2, 4])]

    def run_steps(sess, n=4):
        return np.stack([sess.step()["token"][:3].copy() for _ in range(n)])

    a = G.DecodeSession(params, cfg, max_batch=4, max_len=16)
    first_a = [a.prefill_into(i, prompts[i], seed=i, temperature=0.7)
               for i in range(3)]
    tokens_a = run_steps(a)
    b = G.DecodeSession(params, cfg, max_batch=4, max_len=16)
    first_b = b.prefill_many([0, 1, 2], prompts, seeds=[0, 1, 2],
                             temperature=0.7)
    tokens_b = run_steps(b)
    assert list(b.active[:3]) == [True] * 3 and not b.active[3]
    for fa, fb in zip(first_a, first_b):
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_allclose(fa[k], fb[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_array_equal(tokens_a, tokens_b)


def test_session_rejects_bad_admissions():
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    sess = G.DecodeSession(params, cfg, max_batch=2, max_len=8)
    p = [np.array([1])] * 2
    with pytest.raises(ValueError, match="duplicate"):
        sess.prefill_many([0, 0], p, seeds=[0, 1])
    sess.prefill_into(1, p[0], seed=0)
    with pytest.raises(ValueError, match="occupied"):
        sess.prefill_many([0, 1], p, seeds=[0, 1])
    with pytest.raises(ValueError, match="occupied"):
        sess.prefill_into(1, p[0], seed=0)
    with pytest.raises(ValueError, match="prompt length"):
        sess.prefill_into(0, np.arange(8), seed=0)


def test_prefill_len_bucketing_rules():
    full = get_reduced_config("qwen3-4b")         # full causal attention
    assert G.prefill_len(full, 5, 64) == 8        # ladder pad
    assert G.prefill_len(full, 300, 576) == 300   # past the ladder: exact
    assert G.prefill_len(full, 100, 64) == 64     # clamp to capacity
    win = dataclasses.replace(
        full, block_pattern=(("swa_attn", "swiglu"),), sliding_window=4)
    assert G.prefill_len(win, 3, 64) == 4         # bucket within the window
    assert G.prefill_len(win, 5, 64) == 5         # bucket 8 > window: exact


def test_failed_prefill_fails_only_its_request(monkeypatch):
    """A request whose prefill raises gets the error from result(); the
    server keeps serving the others, and stop() joins its thread."""
    cfg = get_reduced_config("qwen3-4b")
    params = model_lib.init(cfg, seed=0)
    server = Server(cfg, params, max_batch=2, max_len=16)
    real = server.session.prefill_into

    def flaky(slot, prompt, **kw):
        if len(prompt) == 3:
            raise RuntimeError("injected prefill failure")
        return real(slot, prompt, **kw)

    monkeypatch.setattr(server.session, "prefill_into", flaky)
    server.start()
    try:
        bad = server.submit([1, 2, 3], max_tokens=4, seed=0)
        good = server.submit([4, 5], max_tokens=4, seed=1)
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=300)
        assert good.result(timeout=300).shape == (6,)
    finally:
        server.stop()
    assert not server._thread.is_alive()
    assert server.served == 1
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit([1], seed=0)


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-4b", "--prompt-len", "12", "--gen-tokens", "5",
     "--max-batch", "4"],
    ["--arch", "zamba2-2.7b", "--ssd-impl", "kernel", "--prompt-len", "16",
     "--gen-tokens", "8"],
    ["--arch", "granite-moe-1b-a400m", "--prompt-len", "12", "--gen-tokens",
     "5", "--max-batch", "4"],
    ["--arch", "xlstm-125m", "--prompt-len", "16", "--gen-tokens", "8",
     "--max-batch", "4"]],
    ids=["qwen3-4b", "zamba2-2.7b", "granite-moe-1b-a400m", "xlstm-125m"])
def test_serve_cli_on_cpu(capsys, argv):
    """``--device cpu --reduced``: every request served, prompts echoed,
    each admission one flash-attention call per layer (and one SSD chunk
    call per Mamba2 layer) and each decode step one decode-attention call
    per layer — counted nowhere on the CPU, where the wrappers run the
    plain versions."""
    before = kops.stats()
    summary = serve.main(argv + ["--reduced", "--device", "cpu",
                                 "--attn-impl", "kernel", "--requests", "6"])
    assert summary["served"] == 6 and summary["prompt_echo_ok"]
    assert summary["admissions"] == 6 and summary["steps"] > 0
    assert summary["tokens"] >= 6 and summary["tokens_per_s"] > 0
    assert kops.stats() == before
    assert "prompt-echo check: OK" in capsys.readouterr().out


def test_zamba2_session_teacher_forced_matches_jax(monkeypatch):
    """The port's DecodeSession against the reference's on the reduced
    Zamba2 hybrid, float32: two slots admitted with prompts of at most one
    Mamba2 chunk, decoded, one evicted and refilled mid-run. The samplers
    draw differently from a seed, so the port's draw is replaced by the
    token the reference sampled at the same call; every slot's logprob,
    entropy and baseline must then agree within 1e-4, as in
    tests/test_torch_model.py's teacher forcing."""
    _session_teacher_forced(monkeypatch, "zamba2-2.7b")


def test_xlstm_session_teacher_forced_matches_jax(monkeypatch):
    """The same for the reduced xLSTM (prompts of at most one mLSTM chunk,
    16 tokens); a prompt of 24 tokens, over one chunk and not a multiple
    of it, is refused with ValueError (the reference asserts)."""
    cfg = _session_teacher_forced(monkeypatch, "xlstm-125m")
    sess = G.DecodeSession(model_lib.init(cfg, seed=0), cfg, max_batch=1,
                           max_len=32)
    with pytest.raises(ValueError, match="multiple"):
        sess.prefill_into(0, np.arange(24) % cfg.vocab_size, seed=0)


def _session_teacher_forced(monkeypatch, arch):
    """The module's teacher-forced session check (see the Zamba2 test) on
    ``arch``; returns the port's config."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import generate as jgen
    from repro.models import model as jmodel
    from repro_torch.convert import lm_state_dict_from_jax

    jcfg = jconfigs.get_reduced_config(arch)
    cfg = get_reduced_config(arch)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg)
    params = model_lib.init(cfg, seed=0)
    params.load_state_dict(lm_state_dict_from_jax(jparams), strict=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 16, 3)]
    keys = [jax.random.PRNGKey(i) for i in range(3)]

    def schedule(admit, step, evict):
        """The same calls on either session; returns its outputs."""
        outs = [admit(0, prompts[0], 0), admit(1, prompts[1], 1)]
        outs += [step() for _ in range(5)]
        evict(0)
        outs.append(admit(0, prompts[2], 2))
        outs += [step() for _ in range(4)]
        return outs

    jsess = jgen.DecodeSession(jparams, jcfg, max_batch=2, max_len=32)
    want = schedule(
        lambda slot, p, i: dict(jsess.prefill_into(slot, p, key=keys[i],
                                                   temperature=0.8),
                                slot=slot),
        jsess.step, jsess.evict)

    forced = iter(w["token"] for w in want)

    def teacher(logits, temp, gens, active):
        tok = torch.as_tensor(np.array(next(forced)),
                              dtype=torch.int64).reshape(-1)
        lp, ent = G.logprob_entropy(logits / temp[:, None], tok)
        return tok, lp, ent

    monkeypatch.setattr(G, "_sample", teacher)
    sess = G.DecodeSession(params, cfg, max_batch=2, max_len=32)
    got = schedule(
        lambda slot, p, i: dict(sess.prefill_into(slot, p, seed=i,
                                                  temperature=0.8),
                                slot=slot),
        sess.step, sess.evict)
    for n, (g, w) in enumerate(zip(got, want)):
        for key in ("logprob", "entropy", "baseline"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4,
                                       err_msg=f"call {n} {key}")
    return cfg


def test_serve_cli_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-4b", "--reduced", "--requests", "1"])

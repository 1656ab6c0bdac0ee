#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits nonzero without printing a result:

  1. device   the card (nvidia-smi name and power limit), torch and CUDA
  2. build    nvcc builds every kernel from csrc/
  3. kernel   the fused V-trace kernel against its plain PyTorch version on
              the card, at the trainer's and the paper's shapes and beyond
  4. learner  three learner steps of the IMPALA deep ResNet at full width
              (84x84x4 obs, 18 actions, T=80, B=32, Table G.1 RMSProp) on a
              seeded synthetic rollout, held against the plain-loop V-trace
  5. trainer  repro_torch.launch.train.main on gridworld with the deep agent
              (the main path: its kernel launches are the ones reported)
  6. converge Catch with the quickstart settings must reach "SOLVED"
  7. kernels  one {"kernels": [...]} line, then the card's name and power
              limit, then the final {"ok": true, "device": {...}} line

It needs CUDA and the repository's src/ beside it; it exits nonzero when
either is missing. Times are CUDA-event or synchronised host-clock times
taken in this run, on the card named in phase 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
VTRACE_TOL = 1e-5              # expf rounding compounds through <=200 FMAs
VTRACE_SHAPES = [(80, 32), (20, 32), (1, 1), (33, 200), (200, 4096)]
TRAINER_SHAPE = (20, 32)       # (T, B) of the phase-5 main path
# float operations per (t, b) element of the fused kernel: 3 clips, delta
# (4), recurrence (3), vs (1), pg-advantage (4); the expf counts as one
VTRACE_FLOPS_PER_ELEM = 15


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def event_ms(fn, reps, warmup=3):
    """Median over ``reps`` of the CUDA-event time of one call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(fn, launches=50):
    """Device time of one call: a CUDA graph of ``launches`` calls is
    replayed, so host-side wrapper time is left out."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # warm: build, allocate
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return event_ms(graph.replay, reps=10) / launches


def vtrace_inputs(t, b, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (t, b)),
              (rng.random((t, b)) > 0.2) * 0.97,
              rng.normal(0, 1, (t, b)),
              rng.normal(0, 1, (t, b)),
              rng.normal(0, 1, (b,)))
    return [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def vtrace_bound(t, b):
    nbytes = (4 * t * b + b + 2 * t * b) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = VTRACE_FLOPS_PER_ELEM * t * b / FP32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def phase_kernel(ops, ref):
    import torch
    rows = {}
    for i, (t, b) in enumerate(VTRACE_SHAPES):
        for clip in (1.0, None) if (t, b) == (33, 200) else (1.0,):
            args = vtrace_inputs(t, b, seed=1000 + i)
            kw = dict(clip_rho_threshold=clip, clip_c_threshold=clip,
                      clip_pg_rho_threshold=clip)
            got = ops.vtrace_from_importance_weights_kernel(*args, **kw)
            want = ref.ref_vtrace_from_importance_weights(*args, **kw)
            torch.cuda.synchronize()
            abs_err = rel_err = 0.0
            for g, w in zip(got, want):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"vtrace kernel {t}x{b}: non-finite")
                diff = (g - w).abs()
                abs_err = max(abs_err, diff.max().item())
                rel_err = max(rel_err, (diff / w.abs().clamp(min=1e-6))
                              .max().item())
                if not torch.allclose(g, w, rtol=VTRACE_TOL, atol=VTRACE_TOL):
                    raise AssertionError(
                        f"vtrace kernel {t}x{b} clip={clip}: max abs err "
                        f"{diff.max().item():.3e} > tol {VTRACE_TOL}")
            if clip is None:
                emit("kernel", name="vtrace", T=t, B=b, clip=None,
                     max_abs_err=abs_err, max_rel_err=rel_err,
                     tol=VTRACE_TOL)
                continue
            reps = 50 if t * b < 100_000 else 20
            ms = event_ms(lambda: ops.vtrace_from_importance_weights_kernel(
                *args), reps)
            dev_ms = graph_ms(lambda: ops.vtrace_from_importance_weights_kernel(
                *args))
            plain_ms = event_ms(lambda: ref.ref_vtrace_from_importance_weights(
                *args), max(5, reps // 5))
            bound_ms, bound_by = vtrace_bound(t, b)
            row = dict(T=t, B=b, max_abs_err=abs_err, max_rel_err=rel_err,
                       tol=VTRACE_TOL, ms=ms, graph_ms=dev_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None,
                       library_note="no single PyTorch call computes the "
                                    "V-trace recurrence")
            rows[(t, b)] = row
            emit("kernel", name="vtrace", **row)
    return rows


def phase_learner(ops):
    import copy

    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE, TRAIN
    from repro_torch.core import learner as learner_lib
    from repro_torch.models.convnet import impala_deep
    from repro_torch.optim import make_optimizer

    t, b = TRAIN.unroll_length, TRAIN.batch_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {
        "obs": torch.rand((t + 1, b) + OBS_SHAPE, generator=gen,
                          device="cuda"),
        "action": torch.randint(0, NUM_ACTIONS, (t, b), generator=gen,
                                device="cuda", dtype=torch.int32),
        "behavior_logits": torch.randn((t, b, NUM_ACTIONS), generator=gen,
                                       device="cuda"),
        "reward": torch.randint(-1, 2, (t, b), generator=gen,
                                device="cuda").float(),
        "done": torch.rand((t, b), generator=gen, device="cuda") < 0.01,
    }
    agent = impala_deep(OBS_SHAPE, NUM_ACTIONS,
                        generator=torch.Generator().manual_seed(0)).cuda()
    opt = make_optimizer(TRAIN)

    # one step with the plain-loop V-trace from the same weights: the
    # kernel path's first loss must agree with it
    scan_agent = copy.deepcopy(agent)
    scan_step = learner_lib.make_train_step(opt, TRAIN, vtrace_impl="scan")
    _, _, scan_metrics = scan_step(
        scan_agent, opt.init(list(scan_agent.parameters())), 0, batch)
    del scan_agent

    step_fn = learner_lib.make_train_step(opt, TRAIN, vtrace_impl="kernel")
    opt_state = opt.init(list(agent.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.stats()["vtrace"]
    losses, step_ms = [], []
    for step in range(3):
        t0 = time.perf_counter()
        agent, opt_state, metrics = step_fn(agent, opt_state, step, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = ops.stats()["vtrace"] - before
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"learner loss not finite: {losses}")
    if launches != 3:
        raise AssertionError(f"vtrace launches rose by {launches}, not 3")
    scan_loss = float(scan_metrics["loss"])
    if not math.isclose(losses[0], scan_loss, rel_tol=1e-4, abs_tol=1e-4):
        raise AssertionError(f"kernel-path loss {losses[0]} != scan-path "
                             f"loss {scan_loss}")
    emit("learner", agent="impala_deep", obs=list(OBS_SHAPE),
         actions=NUM_ACTIONS, T=t, B=b, losses=losses, scan_loss=scan_loss,
         step_ms=step_ms, steady_step_ms=statistics.median(step_ms[1:]),
         vtrace_launches=launches, peak_mem_bytes=peak)


def run_trainer(argv):
    """train.main(argv) with its log lines captured and echoed."""
    import torch

    from repro_torch.launch import train
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        runtime = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print("  " + line, flush=True)
    return runtime, seconds, lines[-1] if lines else ""


def split_ms(runtime, reps=5):
    """Synchronised host-clock medians of the two halves of a trainer step
    after its run: one rollout from the source, one learner step."""
    import torch

    def timed(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    src = runtime.source
    batch, unroll_ms = timed(lambda: src.next_batch(runtime.params))
    _, learner_ms = timed(lambda: runtime.step_fn(
        runtime.params, runtime.opt_state, runtime.total_steps, batch))
    src.stop()
    return {"unroll_ms": unroll_ms, "learner_ms": learner_ms}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch
    from repro_torch.kernels import build, ops, ref

    # 1. device (resolve_device also pins float32: no TF32 on the card)
    repro_torch.resolve_device("cuda")
    smi = smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32])

    # 2. build
    t0 = time.perf_counter()
    for name in build.SOURCES:
        r = build.build(name)
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds=r["seconds"], ptxas=ptxas)
    emit("build", total_seconds=time.perf_counter() - t0)

    # 3. kernel against plain
    rows = phase_kernel(ops, ref)

    # 4. full-width learner
    phase_learner(ops)

    # 5. the trainer through its entry point: the main path
    ops.reset_stats()
    runtime, seconds, last = run_trainer(
        ["--mode", "rl-agent", "--env", "gridworld", "--agent", "deep",
         "--batch", "32", "--steps", "20"])
    main_path_launches = ops.stats()
    if main_path_launches["vtrace"] < 20:
        raise AssertionError(f"trainer made {main_path_launches} vtrace "
                             "launches, fewer than its 20 steps")
    loss = float(runtime.metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"trainer loss not finite: {loss}")
    emit("trainer", env="gridworld", agent="deep", T=TRAINER_SHAPE[0],
         B=TRAINER_SHAPE[1], steps=20, seconds=seconds,
         ms_per_step=seconds / 20 * 1e3, launches=main_path_launches,
         fps_line=last, **split_ms(runtime))

    # 6. convergence on Catch (the quickstart settings)
    before = ops.stats()["vtrace"]
    runtime, seconds, last = run_trainer(
        ["--mode", "rl-agent", "--env", "catch", "--agent", "minatar",
         "--batch", "32", "--lr", "2e-3", "--steps", "1500"])
    final = float(runtime.metrics["reward_per_step"])
    emit("converge", env="catch", steps=1500, seconds=seconds,
         ms_per_step=seconds / 1500 * 1e3,
         vtrace_launches=ops.stats()["vtrace"] - before,
         final_reward_per_step=final, optimum=0.1, fps_line=last,
         verdict="SOLVED" if final > 0.05 else "not solved",
         **split_ms(runtime))
    if not final > 0.05:
        raise AssertionError(f"Catch not solved: reward/step {final:+.3f}")

    # 7. kernels, card, result
    row = rows[TRAINER_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "vtrace", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vtrace.cu",
        "replaces": "src/repro/kernels/vtrace.py:38",
        "launches": main_path_launches["vtrace"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "graph_ms": row["graph_ms"],
        "shape": list(TRAINER_SHAPE)}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

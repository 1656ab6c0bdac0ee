"""The harness: one run of one cell, driven by the files ``BENCHMARK.json``
names.

A cell names a configuration (``configs/<name>.json``, its weights made by
``configs/<name>.py`` and its plain reference in ``reference/<name>.py``)
and a traffic mix (``traffic/<name>.json``, whose ``kind`` names its
builder in ``traffic/kinds/``). The configuration's ``family`` names the
module in ``families/`` that builds the program's objects the way
``repro_torch.launch.train``'s builders build them and that runs the
check. Each per-layer metric is a reader of its own,
``metrics/<metric>.py``; ``limits/<cell>.json`` holds the limits the
check holds the run to.

A run:

1. set-up: the weights from the seed on the card, the program's source
   and compiled learner step, then ``Runtime.run`` over the first steps
   (``CHECKED`` of them recorded for the check, the rest timed to size
   the window), which warms and captures every graph the window replays;
2. the window: ``Runtime.run`` with ``log_every=0`` and no checkpoint,
   over whole steps sized to fill ``--seconds``, ended by a synchronize;
   with ``--trace 1`` each call into the source and the learner step is a
   span that synchronizes on both sides, and a steady stretch of whole
   steps runs under ``torch.profiler``, its events kept in memory;
3. the peak of device memory is read, the program's state freed, and the
   plain reference (float32, TF32 off) follows the recorded steps; each
   number compared is printed beside its limit.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the steps set-up records for the check: the reference follows them
CHECKED = 3
# a profiled stretch covers about this many seconds of whole steps
PROFILE_SECONDS = 3.0
# the host's threads for the program's work on the CPU (sampling, copies):
# load from one process with few threads
HOST_THREADS = 4


# ---------------------------------------------------------------------------
# the files a cell is made of


def read_json(*parts) -> Any:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(man: dict, workload: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(man: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports: those
    without a ``workloads`` key, and those whose list names it."""
    return [m for m in man[kind]
            if workload in m.get("workloads", [workload])]


def load_reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``: (run) -> value or None."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def forbidden_modules(modules=None) -> List[str]:
    """The names in ``modules`` (default ``sys.modules``) whose top-level
    name, the part before the first dot compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the probes around the program's calls


class Spans:
    """Seconds of each call into a layer; with ``sync`` each span
    synchronizes the device on both sides (the traced run)."""

    def __init__(self, device, sync: bool = False):
        self.device = device
        self.sync = sync
        self.seconds: Dict[str, List[float]] = {}

    def __call__(self, name: str, fn: Callable, *args):
        if not self.sync:
            return fn(*args)
        synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench." + name):
            out = fn(*args)
        synchronize(self.device)
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return out


class SourceProbe:
    """The program's source, as ``Runtime`` sees it: each ``next_batch``
    is a span, and while ``record`` is set its batch is kept for the
    check (copied to the host before the learner step consumes it)."""

    def __init__(self, source, spans: Spans):
        self.source = source
        self.spans = spans
        self.frames_per_batch = source.frames_per_batch
        self.record: Optional[list] = None

    def start(self, params) -> None:
        self.source.start(params)

    def stop(self) -> None:
        self.source.stop()

    def next_batch(self, params):
        batch = self.spans("source", self.source.next_batch, params)
        if self.record is not None:
            self.record.append({k: v.detach().to("cpu", copy=True)
                                for k, v in batch.items()})
        return batch


# ---------------------------------------------------------------------------
# the device


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device_block(chips: int) -> dict:
    """The card's name, the count used and its power limit."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": power_limit_w()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class StepEvents:
    """A CUDA event recorded after each learner step, read after the
    window: the gaps between consecutive step ends, with no synchronize
    per step. On the CPU, the host clock after each step."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_s(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def p95(values: List[float]) -> float:
    """The 95th percentile by the nearest rank above."""
    s = sorted(values)
    return s[min(len(s) - 1, math.ceil(0.95 * len(s)) - 1)]


# ---------------------------------------------------------------------------
# one run


def prepare(workload: str, seed: int, device, *,
            overrides: Optional[dict] = None,
            patch: Optional[Callable] = None) -> SimpleNamespace:
    """A cell's files and its family's ``Setup`` (the program built, no
    step run); ``overrides``: replaced keys of the cell's ``config``,
    ``traffic`` and ``limits`` (the CPU tests' small sizes);
    ``patch(setup)``: called once set-up has built the program, before its
    first step (the tests plant faults with it)."""
    man = manifest()
    cell = find_cell(man, workload)
    over = overrides or {}
    config = merged(read_json("configs", cell["config"] + ".json"),
                    over.get("config"))
    traffic = merged(read_json("traffic", cell["traffic"] + ".json"),
                     over.get("traffic"))
    limits = merged(read_json("limits", workload + ".json"),
                    over.get("limits"))
    family = importlib.import_module("perfbench.families."
                                     + config["family"])
    torch.set_num_threads(HOST_THREADS)
    setup = family.Setup(cell, config, traffic, seed, device)
    if patch is not None:
        patch(setup)
    spans = Spans(device)
    probe = SourceProbe(setup.source, spans)

    def step_fn(*args):
        return spans("learner", setup.step_fn, *args)

    return SimpleNamespace(man=man, cell=cell, config=config,
                           traffic=traffic, limits=limits, setup=setup,
                           spans=spans, probe=probe, step_fn=step_fn,
                           device=device)


def warm_up(c: SimpleNamespace, timing: int) -> float:
    """Set-up's steps through ``Runtime.run``: the ``CHECKED`` steps the
    check follows, recorded, then ``timing`` more; returns the median
    device gap between the step ends after the recorded ones (the steady
    step's seconds), or 0.0 without timing steps."""
    from repro_torch.core.runtime import Runtime

    events = StepEvents(c.device)
    c.probe.record = []

    def on_warm(step, metrics):
        if step < CHECKED:
            c.setup.record_step(step, metrics)
        if step == CHECKED - 1:
            c.probe.record, recorded = None, c.probe.record
            c.setup.record_batches(recorded)
        if step >= CHECKED - 1:
            events.mark()

    Runtime(c.probe, c.step_fn, c.setup.params, c.setup.opt_state,
            total_steps=CHECKED + timing, log_every=0,
            on_metrics=on_warm).run()
    synchronize(c.device)
    return statistics.median(events.gaps_s()) if timing else 0.0


def free_program(c: SimpleNamespace) -> None:
    """Drop the program's state (its params, optimizer state, graphs and
    caches) before the reference runs."""
    c.probe.source = None
    c.setup.free_program()
    gc.collect()
    if torch.device(c.device).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             started: float, device: str = "cuda",
             overrides: Optional[dict] = None,
             patch: Optional[Callable] = None) -> dict:
    """Set-up, window and check of one cell (``prepare``'s arguments);
    returns the result's fields, and the run's pieces under ``_run``."""
    from repro_torch.core.runtime import Runtime

    c = prepare(workload, seed, device, overrides=overrides, patch=patch)
    man, cell, traffic, limits, setup = (c.man, c.cell, c.traffic,
                                         c.limits, c.setup)
    spans, probe, step_fn = c.spans, c.probe, c.step_fn
    warm = CHECKED + int(traffic["timing_steps"])
    est = warm_up(c, warm - CHECKED)
    steps = max(2 if trace else 1, round(seconds / est))

    # the window
    events = StepEvents(device)
    profiled: Dict[str, Any] = {}
    if trace:
        spans.sync = True
        spans.seconds.clear()
        span = max(1, min(steps - 1, round(PROFILE_SECONDS / est)))
        first = warm + max(1, (steps - span) // 2)
        profiled.update(first=first, last=first + span)

    def on_metrics(step, metrics):
        events.mark()
        if trace and step + 1 == profiled["first"]:
            synchronize(device)
            t = time.perf_counter()
            profiled["prof"] = _profiler(device)
            profiled["prof"].start()
            profiled["t0"] = time.perf_counter()
            profiled["overhead"] = profiled["t0"] - t
        if trace and step + 1 == profiled["last"]:
            synchronize(device)
            t = time.perf_counter()
            profiled["wall"] = t - profiled["t0"]
            profiled["prof"].stop()
            profiled["overhead"] += time.perf_counter() - t

    synchronize(device)
    events.mark()
    t0 = time.perf_counter()
    Runtime(probe, step_fn, setup.params, setup.opt_state,
            total_steps=warm + steps, start_step=warm, log_every=0,
            on_metrics=on_metrics).run()
    synchronize(device)
    t1 = time.perf_counter()
    # a traced window leaves out the profiler's own start and stop (its
    # stop reduces the trace on the host)
    window_s = t1 - t0 - profiled.get("overhead", 0.0)
    setup_s = t0 - started
    peak = int(torch.cuda.max_memory_reserved(0)) \
        if torch.device(device).type == "cuda" else 0

    run = SimpleNamespace(
        cell=cell, config=c.config, traffic=traffic, setup=setup,
        window_steps=steps, window_s=window_s, setup_s=setup_s,
        step_gaps_s=events.gaps_s(), spans=spans.seconds, profile=None,
        device=device)
    if trace:
        from perfbench import trace as trace_lib
        run.profile = trace_lib.summarize(
            profiled["prof"], profiled["wall"],
            profiled["last"] - profiled["first"])
        del profiled["prof"]

    e2e = {m["name"]: m for m in metrics_of(man, workload, "end_to_end")}
    rate_metric = traffic["rate_metric"]    # frames or tokens a second
    values: Dict[str, float] = {}
    rate = steps * setup.frames_per_batch / window_s
    if trace:
        for m in metrics_of(man, workload, "per_layer"):
            value = load_reader(m["name"])(run)
            if value is not None:
                values[m["name"]] = value
    else:
        known = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30,
                 "step_ms_p95": 1e3 * p95(run.step_gaps_s),
                 rate_metric: rate}
        values = {name: known[name] for name in e2e}
    units = {m["name"]: m["unit"] for m in man["end_to_end"]
             + man["per_layer"]}

    # the check, once the window has closed and the peak is read
    free_program(c)
    numbers = setup.check()
    checks = {name: {"value": numbers.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    correct = all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
                  for x in checks.values())
    out = {"correct": bool(correct), "attempted": steps, "failed": 0,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()}}
    if trace:
        out["traced_rate"] = {"value": rate,
                              "unit": e2e[rate_metric]["unit"]
                              if rate_metric in e2e else ""}
        if run.profile is not None:
            out["breakdown"] = run.profile["breakdown"]
    out["checks"] = checks
    out["_run"] = run
    out["_peak"] = peak
    return out


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def result_line(out: dict, dev: dict, trace: bool) -> dict:
    """The contract's object, ``device`` from ``dev`` (``device_block``)
    and the run; ``checks`` last."""
    dev = dict(dev, memory_peak_bytes=out["_peak"])
    run = out["_run"]
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = dev
    for k in ("breakdown", "traced_rate"):
        if k in out:
            line[k] = out[k]
    line["checks"] = out["checks"]
    return line


def main(workload: str, seed: int, seconds: float, trace: bool, *,
         started: float) -> int:
    man = manifest()
    cell = find_cell(man, workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 1
    from repro_torch import resolve_device
    device = resolve_device("cuda")        # float32 pinned, TF32 off
    out = run_cell(workload, seed, seconds, trace, started=started,
                   device=str(device))
    held = forbidden_modules()
    if held:
        print("perfbench: the run holds forbidden modules: "
              + ", ".join(held), file=sys.stderr)
        return 1
    line = result_line(out, device_block(chips), trace)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0

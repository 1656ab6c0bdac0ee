"""The actor/learner runtime: one train loop over any ``RolloutSource``.

    source = DeviceSource.for_env(env, agent, unroll_length=20,
                                  batch_size=32, seed=1, pipelined=True)
    step_fn = learner.make_train_step(opt, train_cfg)
    runtime = Runtime(source, step_fn, agent,
                      opt.init(list(agent.parameters())), total_steps=1000)
    agent, opt_state = runtime.run()

The learner step contract is
``(params, opt_state, step:int, batch) -> (params, opt_state, metrics)``;
LR schedules advance through the ``step`` argument.

Off-policy note: pipelined sources hand the learner rollouts generated by
slightly stale parameters. That is the architecture of the paper — the
V-trace correction inside the learner step is what makes it sound.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

# Pretty-names for the metric keys the learner steps emit.
_METRIC_LABELS = {"reward_per_step": "reward/step"}


class Runtime:
    """Drives source.next_batch -> step_fn for total_steps steps.

    Args:
      source: any RolloutSource.
      step_fn: learner step (see module docstring for the contract).
      params, opt_state: initial learner state.
      total_steps: number of learner steps.
      log_every: print metrics every N steps (default total_steps // 20;
        0/None disables printing). Reading a metric waits for the device,
        so printing sparsely keeps the host ahead of the card.
      log_keys: which metric keys to print (default: all scalar ones).
        Each line ends with ``fps``, WINDOWED (since the previous log line,
        so late slowdowns show), and the lifetime average ``fps_avg``.
      checkpoint_dir: not ported yet (raises NotImplementedError).
      on_metrics: optional callback ``(step, metrics)`` invoked every step
        with the raw (device-resident) metrics dict.
      print_fn: sink for log lines.
    """

    def __init__(self, source, step_fn: Callable, params, opt_state, *,
                 total_steps: int,
                 log_every: Optional[int] = None,
                 log_keys: Optional[Sequence[str]] = None,
                 checkpoint_dir: Optional[str] = None,
                 on_metrics: Optional[Callable[[int, Dict[str, Any]], None]]
                 = None,
                 print_fn: Callable[[str], None] = print):
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint/resume is not ported yet (ROADMAP.md, Slice A "
                "item 11: single-process checkpoint + --resume)")
        self.source = source
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.total_steps = total_steps
        if log_every is None:
            log_every = max(1, total_steps // 20)
        self.log_every = log_every
        self.log_keys = log_keys
        self.on_metrics = on_metrics
        self.print_fn = print_fn
        self.frames = 0
        self.metrics: Optional[Dict[str, Any]] = None
        self._win_t: Optional[float] = None    # windowed-FPS anchors
        self._win_frames = 0

    def _log(self, step: int, t0: float) -> None:
        parts = [f"step {step:5d}"]
        if self.frames:
            parts.append(f"frames {self.frames:9d}")
        keys = self.log_keys or list(self.metrics)
        for k in keys:
            value = self.metrics.get(k)
            if value is not None and value.dim() == 0:
                label = _METRIC_LABELS.get(k, k)
                parts.append(f"{label}={float(value):+.3f}")
        now = time.time()
        if self.frames:
            # Windowed throughput (since the previous log line) is the
            # headline number — a lifetime average masks late slowdowns.
            win_t0 = self._win_t if self._win_t is not None else t0
            win_dt = max(now - win_t0, 1e-9)
            parts.append(f"fps={(self.frames - self._win_frames) / win_dt:.0f}")
            dt = max(now - t0, 1e-9)
            parts.append(f"fps_avg={self.frames / dt:.0f}")
        self._win_t, self._win_frames = now, self.frames
        self.print_fn(" ".join(parts))

    def run(self):
        """Run the loop; returns (params, opt_state)."""
        self.source.start(self.params)
        t0 = time.time()
        self._win_t, self._win_frames = t0, self.frames
        try:
            for step in range(self.total_steps):
                batch = self.source.next_batch(self.params)
                self.params, self.opt_state, self.metrics = self.step_fn(
                    self.params, self.opt_state, step, batch)
                self.frames += self.source.frames_per_batch
                if self.on_metrics is not None:
                    self.on_metrics(step, self.metrics)
                if self.log_every and (step % self.log_every == 0
                                       or step == self.total_steps - 1):
                    self._log(step, t0)
        finally:
            self.source.stop()
        return self.params, self.opt_state

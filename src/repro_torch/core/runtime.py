"""The actor/learner runtime: one train loop over any ``RolloutSource``.

    source = DeviceSource.for_env(env, agent, unroll_length=20,
                                  batch_size=32, seed=1, pipelined=True)
    step_fn = learner.make_train_step(opt, train_cfg)
    runtime = Runtime(source, step_fn, agent,
                      opt.init(list(agent.parameters())), total_steps=1000,
                      checkpoint_dir="/tmp/ckpt")
    agent, opt_state = runtime.run()

The learner step contract is
``(params, opt_state, step:int, batch) -> (params, opt_state, metrics)``;
LR schedules advance through the ``step`` argument. ``params`` is the
learner's agent module; its checkpoint leaves are its ``state_dict()``.

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
      start_step: first step index (resume: restore {params, opt_state}
        from a checkpoint and pass its saved step here — the LR schedule
        advances through the step argument, so it continues unbroken).
      log_every: print metrics every N steps (default total_steps // 20;
        0/None disables printing). Reading a metric waits for the device,
        so printing sparsely keeps the host ahead of the card.
      log_keys: which metric keys to print (default: all scalar ones).
      fps_label: label for the throughput column (``fps``, or ``tok/s`` for
        LM pretraining). Each line ends with it, WINDOWED (since the
        previous log line, so late slowdowns show), and the lifetime
        average ``{fps_label}_avg``.
      checkpoint_dir: if set, save {params' state_dict, opt_state} plus the
        source's ``state_dict()`` (the SourceState protocol of
        core/sources.py) to the ``{dir}/step_{total_steps}`` checkpoint at
        the end (and every ``checkpoint_every`` steps when > 0).
        Checkpointing is SNAPSHOT-THEN-WRITE: the loop takes a synchronous
        host copy (``checkpoint.snapshot``) and a background writer thread
        persists it, so the learner never blocks on disk; the writer is
        flushed and joined on every exit path. On a mid-training exception
        a crash checkpoint of the last completed state is saved before
        re-raising — unless the failure came from inside ``step_fn``,
        whose in-place update may have left params and optimizer state
        torn (see ``run``). Resuming from a boundary (periodic/final)
        checkpoint replays the exact batch stream — final params are
        bit-identical to an uninterrupted run.
      checkpoint_meta: extra metadata recorded in every checkpoint's
        manifest alongside ``step`` (the train CLI stores mode/env here
        and validates them on ``--resume``).
      checkpoint_layout: None, or an object whose ``to_disk(leaves)`` maps
        the snapshot's flat host leaves to the keys written (the LM modes
        write the reference's layout: ``convert.LMCheckpointLayout``).
        One with a ``mesh`` (a model-parallel or LM data-parallel rank's)
        makes every rank write its own slices and source state
        (``disk_layout``), the sharded checkpoint of
        ``checkpoint/checkpoint.py``.
      on_metrics: optional callback ``(step, metrics)`` invoked every step
        with the raw (device-resident) metrics dict, after the source's own
        ``on_learner_metrics(step, metrics)`` hook where it has one (replay
        priorities); a source's ``stats()`` gauges join the log line.
      print_fn: sink for log lines.
      mesh: the data mesh of ``--mesh-data N`` (``launch/mesh.py``), the
        LM paths' ``Mesh2D``, or None. Every rank runs this loop over the
        same steps; rank 0 alone prints. Under a data mesh rank 0 alone
        writes checkpoints, and the source's ``stats()`` and
        ``state_dict()`` are collectives, so every rank calls them at the
        same steps; under an LM mesh every rank writes its own slices and
        source state (``checkpoint_layout``). ``frames`` counts the global
        frames (the sharded sources' ``frames_per_batch`` is global). A
        failure skips the crash checkpoint (the other ranks may be gone)
        and propagates, which takes the rank out of the group
        (``launch/mesh.py``).
    """

    def __init__(self, source, step_fn: Callable, params, opt_state, *,
                 total_steps: int, start_step: int = 0,
                 log_every: Optional[int] = None,
                 log_keys: Optional[Sequence[str]] = None,
                 fps_label: str = "fps",
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 checkpoint_meta: Optional[Dict[str, Any]] = None,
                 checkpoint_layout=None,
                 on_metrics: Optional[Callable[[int, Dict[str, Any]], None]]
                 = None,
                 print_fn: Callable[[str], None] = print, mesh=None):
        self.source = source
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.total_steps = total_steps
        self.start_step = start_step
        if log_every is None:
            log_every = max(1, total_steps // 20)
        self.log_every = log_every
        self.log_keys = log_keys
        self.fps_label = fps_label
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_meta = dict(checkpoint_meta or {})
        self.checkpoint_layout = checkpoint_layout
        self._writer = None                    # AsyncCheckpointWriter, lazy
        self.on_metrics = on_metrics
        self.mesh = mesh
        self._main = mesh is None or mesh.is_main
        self.print_fn = print_fn if self._main else (lambda line: None)
        self.frames = 0
        self.metrics: Optional[Dict[str, Any]] = None
        self._win_t: Optional[float] = None    # windowed-FPS anchors
        self._win_frames = 0
        # Sources that learn from the learner (replay priorities) expose an
        # on_learner_metrics hook; the loop calls it after every step.
        self._feedback = getattr(source, "on_learner_metrics", None)

    # -- pieces -------------------------------------------------------------

    def _log(self, step: int, t0: float) -> None:
        # Source-side gauges (ReplaySource: occupancy, mean priority, hit
        # rate) ride along on the line; under a mesh a collective.
        stats_fn = getattr(self.source, "stats", None)
        stats = stats_fn() if stats_fn is not None else {}
        if not self._main:
            return
        parts = [f"step {step:5d}"]
        if self.frames:
            parts.append(f"frames {self.frames:9d}")
        keys = self.log_keys or list(self.metrics)
        for k in keys:
            value = self.metrics.get(k)
            if value is not None and value.dim() == 0:
                label = _METRIC_LABELS.get(k, k)
                parts.append(f"{label}={float(value):+.3f}")
        for k in ("replay_occupancy", "replay_mean_priority",
                  "replay_hit_rate"):
            if k in stats:
                parts.append(f"{k.removeprefix('replay_')}={stats[k]:.3f}")
        now = time.time()
        if self.frames:
            # Windowed throughput (since the previous log line) is the
            # headline number — a lifetime average masks late slowdowns.
            win_t0 = self._win_t if self._win_t is not None else t0
            win_dt = max(now - win_t0, 1e-9)
            parts.append(
                f"{self.fps_label}="
                f"{(self.frames - self._win_frames) / win_dt:.0f}")
            dt = max(now - t0, 1e-9)
            parts.append(f"{self.fps_label}_avg={self.frames / dt:.0f}")
        self._win_t, self._win_frames = now, self.frames
        self.print_fn(" ".join(parts))

    def _checkpoint(self, step: int) -> None:
        from repro_torch import checkpoint as ckpt_lib
        path = f"{self.checkpoint_dir}/step_{step}"
        # SourceState rides along (self-describing): env carry, generator
        # state, the in-flight rollout and the actors' parameter copy — so
        # --resume replays the exact batch stream. Periodic/final
        # checkpoints are taken at step boundaries where the source state
        # is consistent with {params, opt_state, step}.
        # Snapshot-then-write: only the host copy happens here; the disk
        # I/O runs on the writer thread ("saved {path}" is printed there
        # once the manifest lands). Under a mesh every rank gathers its
        # source state to rank 0, whose learner state equals the others'.
        # A rank of an LM mesh writes its own slices and source state.
        source_state = self.source.state_dict()
        sharded = getattr(self.checkpoint_layout, "mesh", None) is not None
        if not self._main and not sharded:
            return
        snap = ckpt_lib.snapshot({"params": self.params.state_dict(),
                                  "opt_state": self.opt_state},
                                 structured={"source": source_state})
        if sharded:
            snap.layout = self.checkpoint_layout.disk_layout(
                list(snap.leaves))
            snap.mesh = self.checkpoint_layout.mesh
        if self.checkpoint_layout is not None:
            snap.leaves = self.checkpoint_layout.to_disk(snap.leaves)
            for key, entry in snap.layout.items():
                if not entry["write"]:     # keep the dtype, drop the bytes
                    snap.leaves[key] = snap.leaves[key][:0]
        if self._writer is None:
            self._writer = ckpt_lib.AsyncCheckpointWriter(
                print_fn=self.print_fn)
        self._writer.submit(path, snap,
                            {"step": step, **self.checkpoint_meta})

    def _crash_checkpoint(self, next_step: int, in_step: bool) -> None:
        """Persist the last completed state after a failure; every failure
        here is logged and swallowed — the ORIGINAL exception is the one
        the caller must see."""
        from repro_torch import checkpoint as ckpt_lib
        try:
            if self._writer is not None:
                self._writer.flush()   # in-flight periodic saves
        except Exception as exc:
            self.print_fn(f"crash checkpoint failed: {exc!r}")
            return
        path = f"{self.checkpoint_dir}/step_{next_step}"
        if self.mesh is not None:
            # the gather of the source state would wait on ranks that may
            # be gone (or blocked in a collective this rank never joins)
            self.print_fn("crash checkpoint skipped: a data-parallel run "
                          "cannot gather its source state after a failure; "
                          "resume from the last periodic checkpoint")
        elif in_step:
            # The learner updates params and optimizer state in place, so
            # a failure inside step_fn may leave them half-updated: such a
            # state must never be saved under any step's name.
            self.print_fn("crash checkpoint skipped: the failure came from "
                          "inside step_fn, whose in-place update may have "
                          "left params/opt_state torn; resume from the last "
                          "periodic checkpoint")
        elif ckpt_lib.is_complete(path):
            self.print_fn(f"crash checkpoint skipped: boundary "
                          f"{path} already saved")
        else:
            try:
                self._checkpoint(next_step)
                self._writer.flush()
            except Exception as exc:  # keep the original primary
                self.print_fn(f"crash checkpoint failed: {exc!r}")

    # -- the loop -----------------------------------------------------------

    def run(self):
        """Run the loop; returns (params, opt_state)."""
        self.source.start(self.params)
        t0 = time.time()
        self._win_t, self._win_frames = t0, self.frames
        # The next step whose update is NOT yet in params/opt_state — the
        # step a crash checkpoint must tell --resume to run first — and
        # whether the failure, if any, came from inside step_fn.
        next_step = self.start_step
        in_step = False
        try:
            for step in range(self.start_step, self.total_steps):
                batch = self.source.next_batch(self.params)
                in_step = True
                self.params, self.opt_state, self.metrics = self.step_fn(
                    self.params, self.opt_state, step, batch)
                in_step = False
                next_step = step + 1
                self.frames += self.source.frames_per_batch
                if self._feedback is not None:
                    self._feedback(step, self.metrics)
                if self.on_metrics is not None:
                    self.on_metrics(step, self.metrics)
                if self.log_every and (step % self.log_every == 0
                                       or step == self.total_steps - 1):
                    self._log(step, t0)
                if (self.checkpoint_dir and self.checkpoint_every
                        and (step + 1) % self.checkpoint_every == 0
                        and step + 1 < self.total_steps):
                    self._checkpoint(step + 1)
            # The final checkpoint is written BEFORE source.stop(): stop()
            # resets dispatch state and recycles replay slots, and the
            # checkpoint must capture the LIVE source state so a later
            # --resume continues the exact rollout stream. (No final save
            # when no step ran — resume past the end would relabel the
            # restored state with a smaller step number.)
            if self.checkpoint_dir and self.start_step < self.total_steps:
                self._checkpoint(self.total_steps)
            # Surface background write failures on the main thread while
            # the run is still "ours" to fail.
            if self._writer is not None:
                self._writer.flush()
        except BaseException:
            # A mid-training failure (actor TimeoutError, SIGINT, OOM) must
            # not discard progress: persist the last COMPLETED state and
            # re-raise. next_step distinguishes a failure before the update
            # (re-run that step on --resume) from one after it (e.g. in a
            # metrics hook — resuming must not re-apply the update). If a
            # periodic checkpoint for next_step already exists it is the
            # BOUNDARY-consistent one (source state captured before this
            # step's dispatch) and the crash snapshot, whose source may
            # have advanced, must not clobber it.
            if self.checkpoint_dir:
                self._crash_checkpoint(next_step, in_step)
            raise
        finally:
            self.source.stop()
            # Join the writer on every exit path; never mask an in-flight
            # exception with an (already logged) background write failure.
            if self._writer is not None:
                self._writer.close(raise_on_error=False)
        return self.params, self.opt_state

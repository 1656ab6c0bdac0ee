"""Cells of the ``impala_agent`` family: the IMPALA conv agent trained by
the program's V-trace learner, built as ``repro_torch.launch.train``'s
``build_rl_agent`` builds it (the learner step in ``compiled.TrainStep``,
the optimizer from ``make_optimizer``, the V-trace kernel), with the
configuration's sizes and Table G.1 hyperparameters, the weights made by
``configs/<config>.py`` from the seed, and the source the traffic mix
builds.

The check (``checks.py``) follows the first ``bench.CHECKED`` steps with
the plain reference; with actors on the device it also holds each
recorded rollout's behaviour logits against the reference's forward with
the parameters the actors held (lagging the learner by the source's
``actor_lag``) and the rollout's transitions against the environment's
rule.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from perfbench import checks
from perfbench.reference import common
from perfbench.seeds import derive
from perfbench.traffic import atari_env, generator


class Setup:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core import compiled
        from repro_torch.core import learner as learner_lib
        from repro_torch.models.convnet import impala_deep
        from repro_torch.optim import make_optimizer

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.weights = importlib.import_module(
            "perfbench.configs." + cell["config"])
        self.reference = importlib.import_module(
            "perfbench.reference." + cell["config"])
        self.config["train"] = dict(
            config["train"], unroll_length=traffic["unroll_length"],
            batch_size=traffic["batch_size"])
        self.train_cfg = TrainConfig(**self.config["train"])
        a = config["agent"]
        with torch.device(self.device):
            agent = impala_deep(
                tuple(a["obs_shape"]), a["num_actions"],
                channels=tuple(a["channels"]), fc=a["fc"],
                generator=torch.Generator(self.device).manual_seed(0))
        w0 = self._weights()
        with torch.no_grad():
            for name, p in agent.named_parameters():
                p.copy_(w0[name])
        del w0
        self.names = [n for n, _ in agent.named_parameters()]
        opt = make_optimizer(self.train_cfg)
        self.step_fn = compiled.TrainStep(learner_lib.make_train_step(
            opt, self.train_cfg, vtrace_impl="kernel"), opt)
        self.params = agent
        self.opt_state = opt.init(list(agent.parameters()))
        feed = generator.make_source(
            traffic, seed=seed, device=self.device, agent=agent,
            obs_shape=tuple(a["obs_shape"]), num_actions=a["num_actions"])
        self.source, self.bank, self.actor_lag = feed
        self.frames_per_batch = self.source.frames_per_batch
        self.losses: List[torch.Tensor] = []
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        self.batches: List[dict] = []

    def _weights(self):
        return self.weights.make_weights(
            self.config, derive(self.seed, "weights"), self.device)

    # -- set-up's records --------------------------------------------------

    def record_step(self, step: int, metrics) -> None:
        from perfbench.bench import CHECKED
        self.losses.append(metrics["loss"].detach().clone())
        if step == 0:
            decay = self.train_cfg.rmsprop_decay
            self.first_grad = {
                n: torch.sqrt(ms.sum() / (1 - decay))
                for n, ms in zip(self.names, self.opt_state["ms"])}
        if step == CHECKED - 1:
            self.after = {n: p.detach().to("cpu", copy=True)
                          for n, p in self.params.named_parameters()}

    def record_batches(self, batches: List[dict]) -> None:
        self.batches = batches

    def free_program(self) -> None:
        self.source = self.step_fn = self.params = self.opt_state = None

    # -- the check -------------------------------------------------------

    def program_outputs(self) -> dict:
        w0 = self._weights()
        return {
            "loss": [float(x) for x in self.losses],
            "grad": {n: float(v) for n, v in self.first_grad.items()},
            "change": {n: float(torch.linalg.vector_norm(
                self.after[n].to(self.device) - w0[n])) for n in self.names},
            "logits": [b["behavior_logits"] for b in self.batches],
        }

    def reference_outputs(self, precision: str = "float32",
                          half: bool = False) -> dict:
        """The reference's steps on the recorded batches at
        ``precision`` (``common.make_cast``); ``half``: the learner
        taking half of each batch's columns (a planted fault)."""
        cast = common.make_cast(precision)
        batches = [{k: v.to(self.device) for k, v in b.items()}
                   for b in self.batches]
        learn = batches
        if half:
            cols = batches[0]["action"].shape[1] // 2
            learn = [{k: v[:, :cols] for k, v in b.items()}
                     for b in batches]
        w0 = self._weights()
        out = self.reference.follow(self._weights(), learn, self.config,
                                    cast)
        held = [w0] + out["after"]
        logits = []
        if self.bank is not None:
            for k, b in enumerate(batches):
                w = held[max(0, k - self.actor_lag)]
                logits.append(self.reference.behaviour_logits(
                    w, b["obs"][:-1], self.config, cast))
        return {
            "loss": out["loss"], "grad": out["grad"],
            "change": {n: float(torch.linalg.vector_norm(
                out["after"][-1][n] - w0[n])) for n in self.names},
            "logits": logits,
        }

    def numbers(self, candidate: dict, reference: dict) -> Dict[str, float]:
        out = checks.training_numbers(candidate, reference)
        if self.bank is not None:
            scale = max(float(r.abs().max()) for r in reference["logits"])
            gap = max(float((c.to(self.device) - r).abs().max())
                      for c, r in zip(candidate["logits"],
                                      reference["logits"]))
            out["logits_gap"] = gap / scale
            out["rule_errors"] = float(sum(
                atari_env.rule_errors(b, self.bank) for b in self.batches))
        return out

    def check(self) -> Dict[str, float]:
        return self.numbers(self.program_outputs(), self.reference_outputs())

    def candidate(self, kind: str) -> dict:
        """Outputs in the program's place: ``control`` the reference at
        TF32 (the precision below float32 with TF32 off), ``half`` the
        reference learning from half of each batch (a planted fault)."""
        if kind == "control":
            return self.reference_outputs("tf32")
        return self.reference_outputs(half=True)

    def control(self, kind: str, reference=None) -> Dict[str, float]:
        """The numbers with ``candidate(kind)`` in the program's place."""
        return self.numbers(self.candidate(kind),
                            reference or self.reference_outputs())

    # -- what the readers count ----------------------------------------------

    def model_flops_per_step(self) -> float:
        """Forward FLOPs of the agent on the learner's (T+1) x B frames
        times three (forward and backward), plus the actors' T x B
        forwards where the cell has actors."""
        from perfbench.counts import impala_deep
        t, b = self.traffic["unroll_length"], self.traffic["batch_size"]
        fwd = impala_deep.forward_flops(self.config["agent"])
        actors = t * b * fwd if self.bank is not None else 0.0
        return 3.0 * (t + 1) * b * fwd + actors

    def vtrace_shape(self):
        return self.traffic["unroll_length"], self.traffic["batch_size"]

"""Cells of the ``decoder`` family: a decoder of the port's registry
trained by the port's LM learners, built as ``repro_torch.launch.train``'s
``build_lm_rl`` and ``build_lm`` build them (the step in
``compiled.TrainStep``, AdamW from ``make_optimizer``, the attention
kernels and the V-trace kernel), with the configuration's sizes
(``ModelConfig`` from its ``model``), the weights made by
``configs/<config>.py`` from the seed and copied into the decoder's tree,
and the source the traffic mix builds: ``generated_episodes`` (lm-rl) or
``packed_corpus`` (lm).

The check (``checks.py``) follows the first ``bench.CHECKED`` steps with
the plain reference; with generated episodes it also holds the first
gradient leaf by leaf (``grad_dir_gap``: the norms alone do not see half
of a batch left out) and the log-probability the generation recorded for
each token (``logprob_gap``: the largest gap, in nats, over the recorded
episodes) against the reference's, under the weights of its step.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

import torch

from perfbench import checks
from perfbench.reference import common
from perfbench.seeds import derive
from perfbench.traffic import generator


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    m = dict(config["model"])
    m["block_pattern"] = tuple(tuple(x) for x in m["block_pattern"])
    return ModelConfig(**m)


class Setup:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core import compiled
        from repro_torch.core import learner as learner_lib
        from repro_torch.core import sources as sources_lib
        from repro_torch.models import model as model_lib
        from repro_torch.optim import make_optimizer

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.mode = traffic["mode"]
        self.weights = importlib.import_module(
            "perfbench.configs." + cell["config"])
        self.reference = importlib.import_module(
            "perfbench.reference." + cell["config"])
        self.config["train"] = dict(config["train"], **traffic["train"])
        self.cfg = model_config(config)
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        self.train_cfg = TrainConfig(**{k: v for k, v in
                                        self.config["train"].items()
                                        if k in fields})
        params = model_lib.init(self.cfg, seed=0, device=self.device)
        w0 = self._weights()
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(w0[name])
        del w0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.names = [n for n, _ in params.named_parameters()]
        opt = make_optimizer(self.train_cfg)
        if self.mode == "lm_rl":
            step = sources_lib.lm_rl_step_from_rollout(
                learner_lib.make_lm_train_step(
                    self.cfg, opt, self.train_cfg,
                    loss_chunk=traffic["episode_length"],
                    vtrace_impl="kernel"))
        else:
            step = learner_lib.make_lm_pretrain_step(
                self.cfg, opt, loss_chunk=min(512, traffic["seq_len"]))
        self.step_fn = compiled.TrainStep(step, opt)
        self.params = params
        self.opt_state = opt.init(list(params.parameters()))
        self.source = generator.make_source(
            traffic, seed=seed, device=self.device,
            model_cfg=self.cfg).source
        self.frames_per_batch = self.source.frames_per_batch
        self.losses: List[torch.Tensor] = []
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.first_grad_vec: Dict[str, torch.Tensor] = {}
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
            b1 = self.train_cfg.adam_b1
            self.first_grad = {
                n: torch.linalg.vector_norm(mu) / (1 - b1)
                for n, mu in zip(self.names, self.opt_state["mu"])}
            if self.mode == "lm_rl":
                # on the host: a copy on the card would raise the peak
                self.first_grad_vec = {
                    n: (mu / (1 - b1)).to("cpu")
                    for n, mu in zip(self.names, self.opt_state["mu"])}
        if step == CHECKED - 1:
            self.after = {n: p.detach().to("cpu", copy=True)
                          for n, p in self.params.named_parameters()}

    def record_batches(self, batches: List[dict]) -> None:
        self.batches = batches

    def free_program(self) -> None:
        self.source = self.step_fn = self.params = self.opt_state = None

    # -- the check -------------------------------------------------------

    def _change(self, after: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Each leaf's change from the seed's weights to ``after``."""
        w0 = self._weights()
        out = {n: float(torch.linalg.vector_norm(
            after[n].to(self.device) - w0[n])) for n in self.names}
        del w0
        return out

    def program_outputs(self) -> dict:
        out = {"loss": [float(x) for x in self.losses],
               "grad": {n: float(v) for n, v in self.first_grad.items()},
               "change": self._change(self.after),
               "served": [b["behavior_logprob"] for b in self.batches]
               if self.mode == "lm_rl" else []}
        if self.mode == "lm_rl":
            out["grad_vec"] = self.first_grad_vec
        return out

    def reference_outputs(self, precision: str = "float32",
                          half: bool = False) -> dict:
        """The reference's steps on the recorded batches at ``precision``
        (``common.make_cast``); ``half``: the learner taking half of each
        batch's rows (a planted fault)."""
        cast = common.make_cast(precision)
        batches = [{k: v.to(self.device) for k, v in b.items()}
                   for b in self.batches]
        if half:
            batches = [{k: (v[:, :v.shape[1] // 2] if self.mode == "lm_rl"
                            else v[:v.shape[0] // 2]) for k, v in b.items()}
                       for b in batches]
        w = self._weights()
        out = self.reference.follow(w, batches, self.config, self.mode, cast)
        out["change"] = self._change(w)
        del w
        return out

    def numbers(self, candidate: dict, reference: dict) -> Dict[str, float]:
        out = checks.training_numbers(candidate, reference)
        if self.mode == "lm_rl":
            out["grad_dir_gap"] = checks.direction_detail(
                candidate["grad_vec"], reference["grad_vec"])["gap"]
            out["logprob_gap"] = max(
                float((c.to(self.device) - r).abs().max())
                for c, r in zip(candidate["served"], reference["served"]))
        return out

    def check(self) -> Dict[str, float]:
        program = self.program_outputs()
        return self.numbers(program, self.reference_outputs())

    def candidate(self, kind: str) -> dict:
        """Outputs in the program's place: ``control`` the reference with
        its activations in float8 (the precision below bfloat16), ``half``
        the reference learning from half of each batch (a planted fault;
        its served log-probabilities are the reference's own)."""
        if kind == "control":
            return self.reference_outputs("fp8")
        out = self.reference_outputs(half=True)
        out["served"] = self.reference_outputs()["served"]
        return out

    def control(self, kind: str, reference=None) -> Dict[str, float]:
        """The numbers with ``candidate(kind)`` in the program's place."""
        return self.numbers(self.candidate(kind),
                            reference or self.reference_outputs())

    # -- what the readers count ----------------------------------------------

    def model_flops_per_step(self) -> float:
        from perfbench.counts import granite_3_0_1b_a400m as count
        m = self.config["model"]
        if self.mode == "lm_rl":
            b, t = self.traffic["batch_size"], self.traffic["episode_length"]
            return count.generation_flops(m, b, t) \
                + 3.0 * count.forward_flops(m, b, t)
        b, s = self.traffic["batch_size"], self.traffic["seq_len"]
        return 3.0 * count.forward_flops(m, b, s)

    def k2_launches(self):
        """(launches a step, shape) of the flash-attention kernel: the
        learner's forward and remat's recompute of it, a layer each, and
        lm-rl's prefill of the one-token prompts."""
        m = self.config["model"]
        layers = m["num_groups"]
        kw = dict(h=m["num_heads"], kh=m["num_kv_heads"], hd=m["head_dim"],
                  dtype_bytes=2, dtype="bfloat16")
        if self.mode == "lm_rl":
            b, t = self.traffic["batch_size"], self.traffic["episode_length"]
            return [(layers, dict(kw, b=b, sq=1, sk=1)),
                    (2 * layers, dict(kw, b=b, sq=t, sk=t))]
        b, s = self.traffic["batch_size"], self.traffic["seq_len"]
        return [(2 * layers, dict(kw, b=b, sq=s, sk=s))]

    def k3_calls(self):
        """(calls a step, shape) of decode attention: each of the episode's
        decode steps at positions 1 .. T-1, a layer each, against the
        T+1-slot cache, of which position + 1 slots are valid."""
        m = self.config["model"]
        b, t = self.traffic["batch_size"], self.traffic["episode_length"]
        return [(m["num_groups"],
                 dict(b=b, h=m["num_heads"], kh=m["num_kv_heads"],
                      valid=pos + 1, hd=m["head_dim"], dtype_bytes=2,
                      slots=t + 1, dtype="bfloat16"))
                for pos in range(1, t)]

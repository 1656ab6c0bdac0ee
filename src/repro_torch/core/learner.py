"""IMPALA learner steps: the paper-faithful agent path (TorchBeast
polybeast.py learner loop body), the LLM-policy path and LM pretraining.

``make_train_step`` returns a function with the reference's contract
  (params, opt_state, step, batch) -> (params, opt_state, metrics)
where ``params`` is the learner's ``nn.Module`` (the agent, or the
decoder's parameter tree), updated in place leaf by leaf (``opt.step``)
and returned, ``step`` a host integer (it drives the LR schedule), and
``metrics`` a dict of device tensors: reading one is the caller's choice
of when to synchronise with the device. These are the plain functions, as
the reference's are un-jitted; ``core/compiled.py::TrainStep`` compiles
the rl-agent steps as the reference's ``launch/train.py`` jits them.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import losses
from repro_torch.distributed import sharding
from repro_torch.models import model as model_lib
from repro_torch.models.common import collective, count_collective, use_rules
from repro_torch.optim.optimizers import zero_view


def _grads(loss, plist):
    """d loss / d params as a list for ``opt.step`` to consume; a
    parameter the loss does not reach (the baseline head under plain LM
    training) gets zeros, as under ``jax.grad``."""
    return list(torch.autograd.grad(loss, plist, allow_unused=True,
                                    materialize_grads=True))


def _router_loss(cfg, aux):
    """The MoE router's auxiliary terms of an LM loss."""
    load_balance, z_loss, _ = aux
    return cfg.router_aux_weight * load_balance \
        + cfg.router_z_weight * z_loss


def make_train_step(opt, train_cfg, *, vtrace_impl="kernel", mesh=None):
    """IMPALA learner step over a rollout batch.

    batch: time-major dict (see core/rollout.py):
      obs (T+1,B,...), action (T,B), behavior_logits (T,B,A),
      reward (T,B), done (T,B) [, is_replay (B,), behavior_value (T,B) —
      ReplaySource batches]

    With an ``is_replay`` mask present, the CLEAR cloning terms
    (losses.clear_auxiliary_loss) are applied to the replayed columns at
    ``train_cfg.clear_policy_cost`` / ``clear_value_cost``, and the
    reported ``reward_per_step`` covers the fresh columns only (replayed
    rewards are not new environment signal).

    vtrace_impl: 'kernel' (the fused CUDA V-trace kernel) or 'scan' (the
    plain reverse loop).

    mesh: the data mesh of ``--mesh-data N`` (``launch/mesh.py``), or None.
    Each rank's ``batch`` is then its own block of B/N columns (and of
    the replayed ones); the step takes the mean over ranks of the
    gradients before ``opt.step`` (``sharding.replicate``, so global-norm
    clipping sees the global gradient), then of the scalar metrics in one
    stacked all-reduce. ``priority`` stays local, in the rank's column
    order. No DDP: its hooks fire on ``.grad`` accumulation, and this step
    takes its gradients with ``torch.autograd.grad``.
    """

    def loss_fn(agent, batch):
        out = agent(batch["obs"])                      # (T+1, B, ...)
        target_logits = out.policy_logits[:-1]
        values = out.baseline[:-1]
        bootstrap = out.baseline[-1].detach()
        discounts = (~batch["done"]).float() * train_cfg.discount
        return losses.impala_loss_from_logits(
            target_logits, batch["behavior_logits"], batch["action"],
            batch["reward"], discounts, values, bootstrap,
            baseline_cost=train_cfg.baseline_cost,
            entropy_cost=train_cfg.entropy_cost,
            clip_rho=train_cfg.vtrace_rho_clip,
            clip_c=train_cfg.vtrace_c_clip,
            is_replay=batch.get("is_replay"),
            behavior_values=batch.get("behavior_value"),
            clear_policy_cost=train_cfg.clear_policy_cost,
            clear_value_cost=train_cfg.clear_value_cost,
            vtrace_impl=vtrace_impl)

    def train_step(params, opt_state, step, batch):
        plist = list(params.parameters())
        loss_out = loss_fn(params, batch)
        grads = _grads(loss_out.total, plist)
        if mesh is not None:
            grads = sharding.replicate(grads, mesh)
        opt_state = opt.step(grads, opt_state, plist, step)
        if "is_replay" in batch:
            fresh = (~batch["is_replay"]).float()[None, :]
            reward_per_step = (batch["reward"] * fresh).sum() \
                / torch.clamp(fresh.sum() * batch["reward"].shape[0],
                              min=1.0)
        else:
            reward_per_step = batch["reward"].mean()
        metrics = {
            "loss": loss_out.total.detach(),
            "pg_loss": loss_out.pg_loss.detach(),
            "baseline_loss": loss_out.baseline_loss.detach(),
            "entropy_loss": loss_out.entropy_loss.detach(),
            "vs_mean": loss_out.vs_mean,
            "rho_mean": loss_out.rho_mean,
            "reward_per_step": reward_per_step,
            "priority": loss_out.priority,
        }
        if "is_replay" in batch:
            metrics["clear_policy_loss"] = loss_out.clear_policy_loss.detach()
            metrics["clear_value_loss"] = loss_out.clear_value_loss.detach()
        if mesh is not None:
            metrics = sharding.mean_scalars(metrics, mesh, skip=("priority",))
        return params, opt_state, metrics

    return train_step


def make_recurrent_train_step(opt, train_cfg, *, vtrace_impl="kernel",
                              mesh=None):
    """IMPALA learner step for recurrent agents (``MinatarLSTMNet``): it
    re-runs the LSTM over the unroll's T+1 observations from the stored
    initial ``core_state`` (TorchBeast's learner does exactly this), with
    ``pre_done[t]`` zeroing the state exactly where the actor did, then
    applies V-trace as ``make_train_step``. The torso carries no state, so
    it runs once over all (T+1)·B observations; only the cell loops.

    batch: ``make_train_step``'s plus pre_done (T+1, B) and core_state
    (h, c). metrics: loss, pg_loss, entropy_loss, reward_per_step, as the
    reference's. vtrace_impl and mesh as in ``make_train_step``.
    """

    def loss_fn(agent, batch):
        feats = agent.features(batch["obs"])           # (T+1, B, core)
        core_state = batch["core_state"]
        logits, baselines = [], []
        for t in range(feats.shape[0]):
            out = agent.cell(feats[t], core_state, batch["pre_done"][t])
            core_state = out.core_state
            logits.append(out.policy_logits)
            baselines.append(out.baseline)
        t = batch["action"].shape[0]
        discounts = (~batch["done"]).float() * train_cfg.discount
        return losses.impala_loss_from_logits(
            torch.stack(logits[:t]), batch["behavior_logits"],
            batch["action"], batch["reward"], discounts,
            torch.stack(baselines[:t]), baselines[t].detach(),
            baseline_cost=train_cfg.baseline_cost,
            entropy_cost=train_cfg.entropy_cost,
            clip_rho=train_cfg.vtrace_rho_clip,
            clip_c=train_cfg.vtrace_c_clip,
            vtrace_impl=vtrace_impl)

    def train_step(params, opt_state, step, batch):
        plist = list(params.parameters())
        loss_out = loss_fn(params, batch)
        grads = _grads(loss_out.total, plist)
        if mesh is not None:
            grads = sharding.replicate(grads, mesh)
        opt_state = opt.step(grads, opt_state, plist, step)
        metrics = {"loss": loss_out.total.detach(),
                   "pg_loss": loss_out.pg_loss.detach(),
                   "entropy_loss": loss_out.entropy_loss.detach(),
                   "reward_per_step": batch["reward"].mean()}
        if mesh is not None:
            metrics = sharding.mean_scalars(metrics, mesh)
        return params, opt_state, metrics

    return train_step


def _lm_update(params, opt, opt_state, step, total, mesh, zero=None):
    """Gradients of ``total`` and the optimizer step, under ``mesh`` (a
    ``Mesh2D`` or None). Over the data group: the mean of each gradient
    (an FSDP leaf's is already summed there by its gather's backward, and
    is divided by the data size), or, for a leaf with a ``zero`` slice
    (ZeRO-2, ``models/model.py::zero_slices``), the rank's slice of the
    mean (a reduce-scatter). Global-norm clipping then counts each leaf
    once, its squares summed over the groups it is split over
    (``sharding.model_global_norm``). At mesh (1, 1) this is the unmeshed
    update, bit for bit."""
    names = [n for n, _ in params.named_parameters()]
    plist = list(params.parameters())
    grads = _grads(total, plist)
    zero = zero or [None] * len(plist)
    fsdp_dims = model_lib.data_dims(params)
    fsdp = [fsdp_dims[n] is not None for n in names]
    extra = {}
    if mesh is not None and mesh.data > 1:
        _reduce_over_data(grads, fsdp, zero, mesh)
    data_split = [f or z is not None for f, z in zip(fsdp, zero)]
    if mesh is not None and (mesh.model > 1 or any(data_split)):
        dims, one = model_lib.split_dims(params), model_lib.owned(params)
        flags = [(dims[n] is not None or one[n], d)
                 for n, d in zip(names, data_split)]
        extra["norm_fn"] = lambda g: sharding.model_global_norm(g, flags,
                                                                mesh)
    return opt.step(grads, opt_state, plist, step, **extra)


def _reduce_over_data(grads, fsdp, zero, mesh):
    """The data group's reduction of the gradients, in place in the list:
    one flat all-reduce (the mean) of the leaves held whole over it, a
    division of the FSDP leaves', and a reduce-scatter to each ZeRO
    slice."""
    whole = [g for g, f, z in zip(grads, fsdp, zero) if not f and z is None]
    if whole:
        t0 = time.perf_counter()
        sharding.replicate(whole, mesh.data_view())
        count_collective("data", "all_reduce",
                         sum(g.numel() * g.element_size() for g in whole),
                         time.perf_counter() - t0)
    for i, (f, z) in enumerate(zip(fsdp, zero)):
        if f:
            grads[i].div_(mesh.data)
        elif z is not None:
            full = collective(grads[i].clone(), "data", "reduce_scatter",
                              mesh=mesh).div_(mesh.data)
            grads[i] = zero_view(full, z).contiguous()


def _lm_metrics(metrics, mesh):
    """The step's metrics, averaged over the data group under a mesh (the
    model ranks of a data index already agree)."""
    if mesh is not None and mesh.data > 1:
        return sharding.mean_scalars(metrics, mesh.data_view())
    return metrics


def make_lm_train_step(cfg, opt, train_cfg, *, loss_chunk=512,
                       vtrace_impl="kernel", mesh=None, rules=None,
                       zero=None):
    """IMPALA learner step for LLM policies.

    ``params`` is the decoder's parameter tree (``models.model.init``),
    updated in place. Attention/SSD impls come from ``cfg.attn_impl`` /
    ``cfg.ssd_impl`` (``ImplContext`` at the CLI boundary): 'kernel'
    runs the flash-attention and SSD chunk kernels under autograd, their
    backward the plain version's VJP. vtrace_impl: 'kernel' (the V-trace
    kernel) or 'scan' (the plain reverse loop).

    batch (batch-major; transposed internally for V-trace):
      tokens            (B, S+1) int   obs[0..S]; actions are tokens[1:]
      behavior_logprob  (B, S) float32 mu(a_t|s_t) of the generating policy
      reward            (B, S) float32
      done              (B, S) bool
      [vision]          (B, Sv, d)     VLM patch embeddings (the stub)

    The loss adds the MoE router's auxiliary terms, ``router_aux_weight``
    times the load-balance loss plus ``router_z_weight`` times the z-loss
    (zero without MoE); the reported ``loss`` leaves them out, as the
    reference's does.

    mesh, rules: the ("data", "model") mesh of ``--mesh-data`` /
    ``--mesh-model`` (a ``Mesh2D``; ``params`` this rank's slices, cut by
    ``model_lib.shard_model``) and its rules table, or None. ``batch`` is
    then this rank's data block; the step runs the model under
    ``use_rules``, all-reduces the gradients over the data group and
    clips by the global norm of the whole tree (``_lm_update``).

    zero: per parameter, this data rank's ``optim.ZeroSlice`` of its
    optimizer state or None (``models/model.py::zero_slices``; ``opt``
    then ``optim.zero1``'s): each gradient is reduce-scattered to its
    slice (ZeRO-2), the reference's ``grad_constraint`` of
    ``launch/specs.py::build_train``.
    """
    def loss_fn(params, batch):
        tokens = batch["tokens"]          # (B, S+1); model sees first S
        # hidden[t] is the state after consuming token t => predicts t+1.
        hidden, aux, _ = model_lib.forward(params, tokens[:, :-1], cfg=cfg,
                                           vision=batch.get("vision"))
        logprob, entropy = losses.chunked_logprob_entropy(
            hidden, model_lib.unembed_matrix(params, cfg), tokens[:, 1:],
            chunk=loss_chunk, final_softcap=cfg.final_logit_softcap,
            vocab_start=model_lib.vocab_start(cfg))
        values_all = model_lib.baseline_from_hidden(params, cfg, hidden)
        bootstrap = torch.zeros((tokens.shape[0],), dtype=torch.float32,
                                device=tokens.device)

        def tm(x):                        # batch -> time major
            return x.transpose(0, 1)

        discounts = (~batch["done"]).float() * train_cfg.discount
        loss_out = losses.impala_loss_from_logprobs(
            tm(logprob), tm(entropy), tm(batch["behavior_logprob"]),
            tm(batch["reward"]), tm(discounts), tm(values_all), bootstrap,
            baseline_cost=train_cfg.baseline_cost,
            entropy_cost=train_cfg.entropy_cost,
            clip_rho=train_cfg.vtrace_rho_clip,
            clip_c=train_cfg.vtrace_c_clip,
            vtrace_impl=vtrace_impl)
        return loss_out.total + _router_loss(cfg, aux), loss_out

    def train_step(params, opt_state, step, batch):
        with use_rules(mesh, rules):
            total, loss_out = loss_fn(params, batch)
            opt_state = _lm_update(params, opt, opt_state, step, total, mesh,
                                   zero)
        metrics = {
            "loss": loss_out.total.detach(),
            "pg_loss": loss_out.pg_loss.detach(),
            "baseline_loss": loss_out.baseline_loss.detach(),
            "entropy_loss": loss_out.entropy_loss.detach(),
            "reward_per_step": batch["reward"].mean(),
        }
        return params, opt_state, _lm_metrics(metrics, mesh)

    return train_step


def make_lm_pretrain_step(cfg, opt, *, loss_chunk=512, mesh=None,
                          rules=None, zero=None):
    """Plain next-token-prediction step (the LM pretraining driver; also
    the non-RL baseline). batch: {"tokens": (B, S+1) int} and, for a VLM,
    "vision" (B, Sv, d) as in ``make_lm_train_step``. Impls come from
    the config as in ``make_lm_train_step``; the gradient includes the
    router's auxiliary terms as there, the reported ``loss`` is the
    cross-entropy alone. mesh, rules and zero as in
    ``make_lm_train_step``."""
    def train_step(params, opt_state, step, batch):
        tokens = batch["tokens"]
        with use_rules(mesh, rules):
            hidden, aux, _ = model_lib.forward(
                params, tokens[:, :-1], cfg=cfg, vision=batch.get("vision"))
            loss = losses.chunked_softmax_xent(
                hidden, model_lib.unembed_matrix(params, cfg),
                tokens[:, 1:], chunk=loss_chunk,
                final_softcap=cfg.final_logit_softcap,
                vocab_start=model_lib.vocab_start(cfg))
            opt_state = _lm_update(params, opt, opt_state, step,
                                   loss + _router_loss(cfg, aux), mesh, zero)
        return params, opt_state, _lm_metrics({"loss": loss.detach()},
                                               mesh)

    return train_step

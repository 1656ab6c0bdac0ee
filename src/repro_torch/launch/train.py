"""Training entry point: config -> Runtime assembly, one builder per mode.

Modes:
  rl-agent  — paper-faithful IMPALA: on-device rollouts (catch/gridworld
              envs) + conv agent + V-trace learner, double-buffered by
              default (``--sync`` to disable, ``--actors host`` for the
              MonoBeast host actor threads).
  lm-rl     — IMPALA with an LLM policy on the token-MDP: the decode
              session generates episodes (behavior log-probs recorded),
              the learner applies V-trace; AdamW.
  lm        — plain next-token pretraining on the synthetic Markov corpus;
              AdamW, and the log line's throughput is ``tok/s``.

The V-trace recursion runs in the fused CUDA kernel by default
(``--vtrace-impl kernel``); ``scan`` selects the plain reverse loop. The
LM modes take ``--arch`` (full published width, or ``--reduced``),
``--seq`` and ``--attn-impl`` / ``--ssd-impl`` (default: the config's);
``kernel`` runs the flash-attention kernel in the learner and the prefill,
the decode-attention kernel in every generated token, and the SSD chunk
kernel in every Mamba2 layer, each under autograd where the learner needs
it (backward: the plain version's VJP).

``--replay {uniform,elite,attentive}`` (rl-agent) wraps either source in
off-policy replay (``ReplaySource``): each learner batch is the fresh
columns plus ``--replay-ratio`` times as many replayed from a buffer of
``--replay-capacity`` rollouts in host memory, and the learner adds the
CLEAR cloning terms on the replayed columns.

``--checkpoint-dir`` saves the learner and source state (with the replay
buffer, the LM data iterator's position or the episode generator's state)
at the end (and every ``--checkpoint-every`` steps); ``--resume``
continues from the latest complete checkpoint there, bit-identically to
an uninterrupted run of the same ``--steps`` for the on-device actors and
both LM modes.

``--mesh-data N`` (rl-agent) learns data-parallel over N ranks, one
process each on ``torch.distributed`` (``launch/mesh.py``: NCCL on CUDA,
gloo on the CPU): rank 0 runs in this process and ranks 1..N-1 are
spawned. Each rank acts on B/N columns (its own unroll stream, actor
pool or replay partition) and the learner all-reduces the gradients, so
every rank holds the same parameters; rank 0 alone prints and writes
checkpoints. On CUDA, N may not exceed the visible GPUs (rank r runs on
``cuda:r``); on the CPU any N runs. ``main`` returns rank 0's Runtime.

``--mesh-data N --mesh-model M`` (lm, lm-rl) trains over the reference's
2-D ("data", "model") mesh of N x M ranks, one process each: each rank
holds its model slice of the decoder (``MEGATRON_RULES``: heads, mlp,
SSM heads and a divisible vocabulary split over "model"), and the token
batch is split over "data" (``launch/mesh.py::Mesh2D``). Every rank
writes its slices of each checkpoint, and ``--resume`` restores onto any
mesh shape (elastic). Mesh (1, 1) is the unmeshed run, bit for bit.

``--coordinator HOST:PORT --num-processes N --process-id i`` runs one
rank per command instead of spawning them (``launch/multihost.py``), in
every mode: the LM modes' (data, model) mesh, or rl-agent's data mesh of
``--mesh-data`` ranks (1 when not given), which must equal N. The
commands together train as the one command that spawns the ranks does.
On CUDA rank r runs on ``cuda:r``, so a spawned mesh needs as many GPUs
(NCCL refuses two ranks on one device; ``launch/mesh.py::launch(devices=,
backend="gloo")`` puts them on one card, as ``chip_smoke.py`` does);
coordinated processes share a card through ``--backend gloo``
(``multihost.coordinated_backend``).

Runs on CUDA unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it raises.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode rl-agent \
      --env catch --steps 1500 --batch 32 --lr 2e-3
  PYTHONPATH=src python -m repro_torch.launch.train --env gridworld \
      --agent deep --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --actors host \
      --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --steps 6 \
      --checkpoint-dir /tmp/ckpt --checkpoint-every 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --env catch \
      --replay elite --replay-ratio 1.0 --steps 500
  PYTHONPATH=src python -m repro_torch.launch.train --actors host \
      --replay uniform --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 2 \
      --device cpu --steps 6 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --mesh-data 1 \
      --env gridworld --agent deep --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm-rl \
      --arch qwen3-4b --reduced --steps 3 --batch 4 --seq 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch zamba2-2.7b --reduced --steps 4 --batch 4 --seq 32 \
      --attn-impl kernel --ssd-impl kernel --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm-rl \
      --arch qwen3-4b --attn-impl kernel --batch 8 --seq 64 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm-rl \
      --arch xlstm-125m --reduced --steps 3 --batch 4 --seq 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch llama-3.2-vision-90b --reduced --attn-impl kernel --steps 2 \
      --batch 2 --seq 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
      --arch qwen3-4b --reduced --steps 4 --batch 8 --seq 32 \
      --mesh-model 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode lm-rl \
      --arch qwen3-4b --reduced --steps 3 --batch 8 --seq 16 \
      --mesh-data 2 --mesh-model 2 --device cpu

A VLM (``vision_seq``) trains in ``--mode lm`` on the vision stub (zero
patch embeddings); ``--mode lm-rl`` refuses it, as the reference's does
(its decode session serves text-only configs). An xLSTM's ``--seq`` is at
most ``xlstm_chunk`` (64; 16 reduced) or a multiple of it.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.convert import LMCheckpointLayout
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.atari_impala import small_train
from repro_torch.configs.base import ImplContext, TrainConfig
from repro_torch.core import compiled
from repro_torch.core import learner as learner_lib
from repro_torch.core import sources as sources_lib
from repro_torch.core.runtime import Runtime
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import dtype_of
from repro_torch.models.convnet import impala_deep, minatar_net
from repro_torch.optim import make_optimizer

def build_rl_agent(args, mesh=None):
    """The rl-agent run: (device | sharded | host) actors, optionally
    wrapped in replay, every combination with ``mesh`` (this rank's
    ``DataMesh`` under ``--mesh-data``) composing as the reference's."""
    from repro_torch.envs import catch, gridworld
    device = resolve_device(args.device) if mesh is None else mesh.device
    env = {"catch": catch, "gridworld": gridworld}[args.env].make()
    train_cfg = small_train(total_steps=args.steps,
                            learning_rate=args.lr or 2e-3,
                            batch_size=args.batch or 32)
    if args.replay != "off":
        train_cfg = dataclasses.replace(train_cfg, clear_policy_cost=0.01,
                                        clear_value_cost=0.005)
    net = impala_deep if args.agent == "deep" else minatar_net
    agent = net(env.obs_shape, env.num_actions,
                generator=torch.Generator().manual_seed(train_cfg.seed))
    agent = agent.to(device)
    opt = make_optimizer(train_cfg)
    if args.actors == "host":
        # the envs step on the CPU in actor threads; policy and learner
        # run on the run's device
        source = sources_lib.HostLoopSource(
            env, agent, num_actors=train_cfg.num_actors,
            unroll_length=train_cfg.unroll_length,
            batch_size=train_cfg.batch_size, seed=train_cfg.seed, mesh=mesh)
    elif mesh is not None:
        source = sources_lib.ShardedDeviceSource.for_env(
            env, agent, unroll_length=train_cfg.unroll_length,
            batch_size=train_cfg.batch_size, seed=train_cfg.seed + 1,
            mesh=mesh, pipelined=not args.sync)
    else:
        source = sources_lib.DeviceSource.for_env(
            env, agent, unroll_length=train_cfg.unroll_length,
            batch_size=train_cfg.batch_size, seed=train_cfg.seed + 1,
            pipelined=not args.sync)
    if args.replay != "off":
        from repro_torch.core import replay as replay_lib
        buffer = replay_lib.make_buffer(args.replay, args.replay_capacity) \
            if mesh is None else replay_lib.ShardedReplay(
                args.replay, args.replay_capacity, mesh)
        # the reference's jitted value function: a CUDA graph of the
        # forward on the card
        source = sources_lib.ReplaySource(
            source, buffer, replay_ratio=args.replay_ratio,
            seed=train_cfg.seed, value_fn=compiled.Forward(_baseline))
    # the reference's jax.jit(make_train_step(...)): a CUDA graph of the
    # step on the card, eager under a data mesh (its all-reduce)
    step_fn = compiled.TrainStep(
        learner_lib.make_train_step(opt, train_cfg,
                                    vtrace_impl=args.vtrace_impl, mesh=mesh),
        opt, mesh=mesh)
    opt_state = opt.init(list(agent.parameters()))
    extras = {"log_keys": ("reward_per_step", "loss")}
    return source, step_fn, agent, opt_state, extras


def _baseline(agent, obs):
    return agent(obs).baseline


def compiled_summary(step_fn, device, device_actors=True, *,
                     mode="rl-agent", replay=False) -> str:
    """The run's line on what replays CUDA graphs on ``device``: the
    learner step (eager by rule under a mesh); rl-agent's device actors'
    unroll or host actors' policy, and with ``replay`` its value function;
    lm-rl's generation (the decode step and the admissions, eager with
    the learner step under a mesh)."""
    if torch.device(device).type != "cuda":
        return "compiled: nothing on the CPU (the plain functions run)"
    graphed = ["the learner step"] if step_fn.compiled else []
    if mode == "rl-agent":
        graphed.append("the unroll" if device_actors
                       else "the host actors' policy")
        if replay:
            graphed.append("replay's value function")
    elif mode == "lm-rl" and step_fn.compiled:
        graphed.append("the generation (decode step, admissions)")
    if len(graphed) > 2:
        graphed = [", ".join(graphed[:-1]), graphed[-1]]
    line = "compiled: " + (" and ".join(graphed) or "nothing") \
        + " as CUDA graphs"
    if step_fn.compiled:
        return line
    if mode == "rl-agent":
        return line + ("; the learner step eager by rule under --mesh-data "
                       "(its gradient all-reduce is a collective no graph "
                       "captures)")
    eager = "the learner step" + (" and the generation" if mode == "lm-rl"
                                  else "")
    return line + (f"; {eager} eager by rule under --mesh-data / "
                   "--mesh-model (the mesh's collectives, which no graph "
                   "captures)")


def _lm_config(args):
    """The arch's config (published or ``--reduced``) with --attn-impl /
    --ssd-impl folded in (the one ImplContext every path below reads)."""
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    return ImplContext.from_args(args).apply(cfg)


def _lm_layout(params, mesh=None):
    """The LM modes checkpoint in the reference's layout (block leaves
    stacked on the group axis, AdamW's mu and nu as trees), so that each
    package resumes the other's checkpoints; under a mesh every rank
    writes its slices (``LMCheckpointLayout.disk_layout``)."""
    names = [n for n, _ in params.named_parameters()]
    if mesh is None:
        return LMCheckpointLayout(names)
    return LMCheckpointLayout(names, params.model_layout, mesh)


def _lm_params(args, cfg, seed, mesh):
    """(device, the decoder's params, rules): the whole tree from
    ``seed``, cut to this rank's model slices under ``mesh``."""
    device = resolve_device(args.device) if mesh is None else mesh.device
    params = model_lib.init(cfg, seed=seed, device=device)
    rules = None
    if mesh is not None:
        rules = sharding.rules_named("megatron")
        model_lib.shard_model(params, cfg, mesh, rules)
    return device, params, rules


def build_lm_rl(args, mesh=None):
    """The lm-rl run; ``mesh``: this rank's ``Mesh2D`` (--mesh-data /
    --mesh-model), or None."""
    cfg = _lm_config(args)
    train_cfg = TrainConfig(optimizer="adamw", learning_rate=args.lr or 3e-4,
                            grad_clip=1.0, total_steps=args.steps,
                            lr_schedule="constant", entropy_cost=0.003)
    _, params, rules = _lm_params(args, cfg, train_cfg.seed, mesh)
    opt = make_optimizer(train_cfg)
    opt_state = opt.init(list(params.parameters()))
    source = sources_lib.GeneratorSource(
        cfg, batch_size=args.batch or 16, episode_length=args.seq, seed=7,
        mesh=mesh, rules=rules)
    # the reference's jitted step: a CUDA graph of it on the card, eager
    # under a mesh (its collectives)
    step_fn = compiled.TrainStep(sources_lib.lm_rl_step_from_rollout(
        learner_lib.make_lm_train_step(cfg, opt, train_cfg,
                                       loss_chunk=args.seq,
                                       vtrace_impl=args.vtrace_impl,
                                       mesh=mesh, rules=rules)), opt,
        mesh=mesh)
    extras = {"log_keys": ("reward_per_step", "pg_loss", "entropy_loss"),
              "checkpoint_layout": _lm_layout(params, mesh)}
    return source, step_fn, params, opt_state, extras


def build_lm(args, mesh=None):
    """The lm run; ``mesh`` as in ``build_lm_rl``."""
    from repro_torch.data import PackedBatchIterator, markov_corpus
    cfg = _lm_config(args)
    train_cfg = TrainConfig(optimizer="adamw", learning_rate=args.lr or 3e-4,
                            grad_clip=1.0, total_steps=args.steps,
                            lr_schedule="cosine", warmup_steps=10)
    device, params, rules = _lm_params(args, cfg, 0, mesh)
    opt = make_optimizer(train_cfg)
    opt_state = opt.init(list(params.parameters()))
    step_fn = learner_lib.make_lm_pretrain_step(
        cfg, opt, loss_chunk=min(512, args.seq), mesh=mesh, rules=rules)
    b = args.batch or 16
    if cfg.vision_seq:
        # the VLM's vision stub, as the reference's: zero patch embeddings
        # in the activation type beside every (this rank's) batch
        rows = b if mesh is None else b // mesh.data
        vision = torch.zeros((rows, cfg.vision_seq, cfg.d_model),
                             dtype=dtype_of(cfg), device=device)
        pretrain_step = step_fn

        def step_fn(params, opt_state, step, batch):
            return pretrain_step(params, opt_state, step,
                                 dict(batch, vision=vision))
    # the reference's jitted step, as build_lm_rl's (the vision stub is
    # static memory already)
    step_fn = compiled.TrainStep(step_fn, opt, mesh=mesh)
    corpus = markov_corpus(cfg.vocab_size, 200_000, seed=1)
    # Checkpointable iterator (seed + offset): its state rides in every
    # checkpoint through DataSource.state_dict, so --resume replays the
    # exact batch sequence (bit-identical to an uninterrupted run).
    it = PackedBatchIterator(corpus, b, args.seq, seed=train_cfg.seed)

    source = sources_lib.DataSource(it, frames_per_batch=b * args.seq,
                                    device=device, mesh=mesh, rules=rules)
    extras = {"log_keys": ("loss",), "fps_label": "tok/s",
              "checkpoint_layout": _lm_layout(params, mesh)}
    return source, step_fn, params, opt_state, extras


_BUILDERS = {"rl-agent": build_rl_agent, "lm-rl": build_lm_rl,
             "lm": build_lm}


def _parser():
    p = argparse.ArgumentParser(description="IMPALA trainer (PyTorch port)")
    p.add_argument("--mode", default="rl-agent", choices=sorted(_BUILDERS))
    p.add_argument("--env", choices=["catch", "gridworld"], default="catch")
    p.add_argument("--agent", choices=["minatar", "deep"], default="minatar")
    p.add_argument("--actors", choices=["device", "host"], default="device",
                   help="on-device batched rollouts, or the MonoBeast host "
                        "actor threads (envs on the CPU, policy batched on "
                        "the device)")
    p.add_argument("--sync", action="store_true",
                   help="disable double-buffered rollout dispatch")
    p.add_argument("--vtrace-impl", choices=["kernel", "scan"],
                   default="kernel",
                   help="rl-agent/lm-rl V-trace: the fused CUDA kernel (its "
                        "plain version on the CPU) or the plain reverse loop")
    p.add_argument("--arch", default="qwen3-4b",
                   help="lm/lm-rl: the decoder's config")
    p.add_argument("--reduced", action="store_true",
                   help="lm/lm-rl: the arch's small same-family variant")
    p.add_argument("--seq", type=int, default=64,
                   help="lm/lm-rl: sequence (episode) length")
    p.add_argument("--attn-impl", default=None,
                   choices=["xla", "xla_chunked", "xla_chunked_skip",
                            "kernel"],
                   help="lm/lm-rl: 'kernel' runs the flash-attention kernel "
                        "in the learner and the prefill and the decode-"
                        "attention kernel per generated token (their plain "
                        "versions on the CPU); the others name plain "
                        "PyTorch paths; default: the config's")
    p.add_argument("--ssd-impl", default=None, choices=["xla", "kernel"],
                   help="lm/lm-rl: Mamba2 chunk-scan impl — 'kernel' runs "
                        "the SSD chunk kernel once per chunk (its plain "
                        "version on the CPU); default: the config's")
    p.add_argument("--replay", choices=["off", "uniform", "elite",
                                        "attentive"], default="off",
                   help="off-policy replay strategy (mixed batches with "
                        "CLEAR cloning on the replayed columns)")
    p.add_argument("--replay-capacity", type=int, default=512,
                   help="rollouts the replay buffer holds (host memory)")
    p.add_argument("--replay-ratio", type=float, default=1.0,
                   help="replayed:fresh columns per learner batch")
    p.add_argument("--mesh-data", type=int, default=0, metavar="N",
                   help="data-parallel learning over N ranks, one process "
                        "each (NCCL on CUDA, at most the visible GPUs; gloo "
                        "on the CPU); lm/lm-rl: the 'data' axis of the "
                        "('data', 'model') mesh; 0: one process, no mesh")
    p.add_argument("--mesh-model", type=int, default=0, metavar="M",
                   help="lm/lm-rl: the 'model' axis of the ('data', "
                        "'model') mesh: MEGATRON_RULES split the decoder's "
                        "parameters over M ranks, the token batch over "
                        "--mesh-data; composes with --resume (elastic)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="run ONE rank of the mesh in this process "
                        "(--process-id of --num-processes), joining the "
                        "others at process 0's rendezvous HOST:PORT "
                        "(launch/multihost.py) instead of spawning them")
    p.add_argument("--num-processes", type=int, default=1,
                   help="with --coordinator: the mesh's rank count")
    p.add_argument("--process-id", type=int, default=0,
                   help="with --coordinator: this process's rank")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="with --coordinator: the process group's backend "
                        "(default: NCCL on CUDA, gloo on the CPU or where "
                        "this host's LOCAL_WORLD_SIZE processes outnumber "
                        "its GPUs); gloo lets processes share one card")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save {params, opt_state} and the source state to "
                        "step_<N>/ here at the end of the run")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N steps (0: final/crash "
                        "checkpoints only) — the kill/--resume safety net")
    p.add_argument("--resume", action="store_true",
                   help="restore {params, opt_state, step} AND the rollout "
                        "source state from the latest checkpoint in "
                        "--checkpoint-dir and continue from the saved step "
                        "— bit-identical to an uninterrupted run of the "
                        "same --steps for the on-device actors")
    return p


def _checkpoint_meta(args):
    """Config identity recorded in every checkpoint manifest and validated
    on --resume: restoring an lm checkpoint into an rl-agent run (or a
    different arch/env) must fail loudly up front, naming the mismatched
    keys."""
    meta = {"mode": args.mode}
    if args.mode == "rl-agent":
        meta["env"] = args.env
    else:
        meta["arch"] = args.arch
    return meta


def _resume(args, source, params, opt_state, layout=None, print_fn=print,
            mesh=None):
    """Load the latest checkpoint under --checkpoint-dir into the learner's
    module, the optimizer state and the source (under a mesh, each rank
    reads it and takes its own entries); returns (opt_state,
    start_step). ``layout``: the LM modes' ``LMCheckpointLayout``, whose
    checkpoints either package may have written, on any mesh: a rank of
    an LM mesh (``mesh``, a ``Mesh2D``) restores its own blocks and, when
    the checkpoint was written by as many processes, its own source
    state (else the source starts fresh, as the reference's)."""
    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.tree import flatten
    path = ckpt_lib.latest_step_path(args.checkpoint_dir)
    if path is None:
        print_fn(f"--resume: no checkpoint under {args.checkpoint_dir}, "
                 "starting fresh")
        return opt_state, 0
    # Cheap pre-flight: the manifest's recorded config identity must match
    # this run before any shard is read.
    saved_meta = ckpt_lib.read_metadata(path)
    want = _checkpoint_meta(args)
    bad = sorted(k for k in want
                 if k in saved_meta and saved_meta[k] != want[k])
    if bad:
        detail = ", ".join(f"{k}: checkpoint={saved_meta[k]!r} "
                           f"run={want[k]!r}" for k in bad)
        raise SystemExit(f"--resume: checkpoint {path} was written by a "
                         f"different configuration ({detail})")
    # SourceState: replay the exact rollout stream (env carry, generator,
    # in-flight rollout, the actors' parameter copy; the LM iterator's
    # position or the episode generator).
    if isinstance(mesh, mesh_lib.Mesh2D):
        source_state = ckpt_lib.restore_structured(
            path, "source", process=mesh.rank, num_processes=mesh.size)
    else:
        source_state = ckpt_lib.restore_structured(path, "source")
    if args.mode == "lm-rl" and source_state is not None \
            and "generator" not in source_state:
        raise SystemExit(
            f"--resume: checkpoint {path} was written by the JAX package: "
            "its episode generator's state is a threefry key, which no "
            "torch.Generator can continue, so an lm-rl run does not "
            "resume across packages (its episodes would start a fresh "
            "stream); --mode lm checkpoints do")
    like = {"params": params.state_dict(), "opt_state": opt_state}
    if layout is None:
        restored, meta = ckpt_lib.restore(path, like)
        params.load_state_dict(restored["params"])
        opt_state = restored["opt_state"]
    else:
        leaves = flatten(like)
        blocks = None
        if layout.mesh is not None:
            blocks = {key: (entry["shape"], entry["index"])
                      for key, entry in layout.disk_layout(
                          [k for k, _ in leaves]).items()}
        on_disk, meta = ckpt_lib.restore(
            path, layout.template([(k, v.shape) for k, v in leaves]),
            shardings=blocks)
        arrays = layout.from_disk(dict(flatten(on_disk)),
                                  [k for k, _ in leaves])
        with torch.no_grad():
            for key, leaf in leaves:
                leaf.copy_(torch.from_numpy(arrays[key]))
    start_step = int(meta.get("step", 0))
    if source_state is not None:
        source.load_state_dict(source_state)
    print_fn(f"resumed {path} at step {start_step}"
             + (" (source state restored)" if source_state is not None
                else ""))
    return opt_state, start_step


def main(argv=None) -> Runtime:
    """Parse ``argv``, train, and return the finished Runtime (its
    ``params`` are the trained agent or decoder, ``metrics`` the last
    step's)."""
    p = _parser()
    args = p.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        p.error("--resume requires --checkpoint-dir")
    if args.mesh_model and args.mode == "rl-agent":
        p.error("--mesh-model applies to the LM paths (--mode lm/lm-rl); "
                "rl-agent is data-parallel only (--mesh-data)")
    if args.backend and not args.coordinator:
        p.error("--backend applies with --coordinator")
    if args.num_processes > 1 and not args.coordinator:
        # without the rendezvous each process would train a whole model
        # of its own and clobber the shared checkpoint directory
        p.error("--num-processes > 1 requires --coordinator")
    lm_mesh = args.mode != "rl-agent" and bool(
        args.mesh_data or args.mesh_model or args.coordinator)
    if lm_mesh:
        data, model = args.mesh_data or 1, args.mesh_model or 1
        cfg = _lm_config(args)
        try:
            model_lib.check_model_parallel(cfg, model)
        except ValueError as exc:
            p.error(str(exc))
        device = resolve_device(args.device)    # no GPU: raises here
        if args.coordinator:
            from repro_torch.launch.multihost import bootstrap
            with bootstrap(args.coordinator, args.num_processes,
                           args.process_id, data=data, model=model,
                           device=device, backend=args.backend) as mesh:
                return _train(mesh, args)
        return mesh_lib.launch(_train, data * model, device=device,
                               args=(args,), model=model)
    if args.coordinator:
        # rl-agent, one rank of the --mesh-data data mesh a process
        from repro_torch.launch.multihost import bootstrap
        device = resolve_device(args.device)    # no GPU: raises here
        with bootstrap(args.coordinator, args.num_processes,
                       args.process_id, data=args.mesh_data or 1,
                       device=device, backend=args.backend) as mesh:
            return _train(mesh, args)
    if args.mesh_data:
        device = resolve_device(args.device)    # no GPU: raises here
        return mesh_lib.launch(_train, args.mesh_data, device=device,
                               args=(args,))
    return _train(None, args)


def _train(mesh, args) -> Runtime:
    """Build, resume and run one process's part of the training: all of it
    without a mesh, else this rank's (the body every rank runs)."""
    print_fn = print if mesh is None or mesh.is_main else (lambda line: None)
    lm_mesh = isinstance(mesh, mesh_lib.Mesh2D)
    if mesh is None:
        built = _BUILDERS[args.mode](args)
    else:
        resolve_device(args.device)   # pins float32 in a spawned rank too
        built = (_BUILDERS[args.mode](args, mesh) if lm_mesh
                 else build_rl_agent(args, mesh))
    source, step_fn, params, opt_state, extras = built
    start_step = 0
    if args.resume:
        opt_state, start_step = _resume(
            args, source, params, opt_state,
            extras.get("checkpoint_layout"), print_fn, mesh)
    if mesh is not None and not lm_mesh:
        sharding.broadcast_module(params, mesh)   # rank 0's params everywhere
    print_fn(compiled_summary(step_fn, next(params.parameters()).device,
                              args.actors == "device", mode=args.mode,
                              replay=args.replay != "off"))
    runtime = Runtime(source, step_fn, params, opt_state,
                      total_steps=args.steps, start_step=start_step,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_meta=_checkpoint_meta(args),
                      print_fn=print_fn, mesh=mesh, **extras)
    runtime.run()
    return runtime


if __name__ == "__main__":
    main()

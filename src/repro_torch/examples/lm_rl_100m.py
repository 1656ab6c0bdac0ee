"""End-to-end driver: IMPALA-train a ~100M-parameter decoder policy on the
token-MDP for a few hundred steps (the LLM-scale instantiation of the
TorchBeast architecture).

The policy is a Qwen3-family decoder scaled to ~100M parameters. Actors:
``generate`` (behaviour log-probs recorded; on the card its admission and
decode step replay CUDA graphs); learner: V-trace and the policy gradient
on the generated episodes, a CUDA graph of the step on the card
(``compiled.TrainStep``). Reward: the fraction of tokens that follow the
hidden affine chain; a learning policy climbs from 1/V toward 1.0.

Attention runs the port's kernels: flash attention in the prefill and the
learner, decode attention in every generated token (``attn_impl``
``kernel``; the reference's config keeps ``auto``, its dense plain path at
these lengths).

  PYTHONPATH=src python -m repro_torch.examples.lm_rl_100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.lm_rl_100m --d-model 64 \\
      --layers 2 --vocab 64 --steps 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import compiled
from repro_torch.core import generate as gen_lib
from repro_torch.core import learner as learner_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import make_optimizer

# the hidden affine chain: token t+1 should be (A_MOD * token_t + B_MOD) % V
A_MOD, B_MOD = 5, 3


def make_100m_config(d_model, layers, vocab):
    """Qwen3-family block at ~100M params (d=512, 12L, V=8192 -> ~47M body
    + embeddings; d=640/16L pushes ~100M)."""
    base = get_config("qwen3-4b")
    return dataclasses.replace(
        base, name="qwen3-100m", d_model=d_model, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=4 * d_model, vocab_size=vocab,
        num_groups=layers, attn_chunk=256, ssm_chunk=64,
        dtype="float32", remat=False, tie_embeddings=True)


def episode_batch(ep, vocab_size):
    """The learner's batch of one ``generate`` output: the tokens, their
    behaviour log-probs, the affine chain's reward (1 where a token
    follows its predecessor's target) and ``done`` at each episode's
    last step."""
    tokens = ep["tokens"]
    target = (A_MOD * tokens[:, :-1] + B_MOD) % vocab_size
    reward = (tokens[:, 1:] == target).float()
    done = torch.zeros_like(reward, dtype=torch.bool)
    done[:, -1] = True
    return {"tokens": tokens, "behavior_logprob": ep["logprob"],
            "reward": reward, "done": done}


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ep-len", type=int, default=32)
    p.add_argument("--d-model", type=int, default=640)
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--vocab", type=int, default=512,
                   help="small vocab keeps random-hit reward discoverable "
                        "(1/V per token); 512 learns in ~100 steps")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def build(args):
    """(cfg, train_cfg, params, opt, opt_state, train_step) of ``args``:
    ``make_100m_config`` on the attention kernels (their plain versions
    on the CPU), the weights from seed 0, AdamW, the learner step compiled
    as the reference jits it."""
    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        make_100m_config(args.d_model, args.layers, args.vocab),
        attn_impl="kernel")
    tc = TrainConfig(optimizer="adamw", learning_rate=args.lr,
                     grad_clip=1.0, lr_schedule="constant",
                     entropy_cost=0.002, baseline_cost=0.5,
                     total_steps=args.steps)
    params = model_lib.init(cfg, seed=0, device=device)
    opt = make_optimizer(tc)
    opt_state = opt.init(list(params.parameters()))
    train_step = compiled.TrainStep(learner_lib.make_lm_train_step(
        cfg, opt, tc, loss_chunk=args.ep_len), opt)
    return cfg, tc, params, opt, opt_state, train_step


def draw(gen, args, vocab_size):
    """One step's prompts (B, 1) and ``generate`` seed from ``gen``."""
    prompt = torch.randint(0, vocab_size, (args.batch, 1), generator=gen)
    seed = int(torch.randint(0, 2 ** 31 - args.batch, (), generator=gen))
    return prompt, seed


def main(argv=None) -> dict:
    """Train and print the reference's lines; returns every step's reward
    a step, the printed lines, the last metrics and the run's seconds."""
    args = _parser().parse_args(argv)
    cfg, _, params, _, opt_state, train_step = build(args)
    print(f"policy: {cfg.name} ~{cfg.param_count()/1e6:.0f}M params")
    gen = torch.Generator().manual_seed(7)
    rewards, lines = [], []
    t0 = time.time()
    for step in range(args.steps):
        prompt, seed = draw(gen, args, cfg.vocab_size)
        ep = gen_lib.generate(params, prompt, seed, cfg=cfg,
                              num_steps=args.ep_len)
        params, opt_state, m = train_step(params, opt_state, step,
                                          episode_batch(ep, cfg.vocab_size))
        rewards.append(m["reward_per_step"])
        if step % max(1, args.steps // 25) == 0 or step == args.steps - 1:
            toks = (step + 1) * args.batch * args.ep_len
            line = {"step": step,
                    "reward_per_step": float(m["reward_per_step"]),
                    "entropy": -float(m["entropy_loss"]) / args.ep_len,
                    "tok_s": toks / (time.time() - t0)}
            print(f"step {step:4d} reward/step="
                  f"{line['reward_per_step']:.4f} "
                  f"H={line['entropy']:.2f} tok/s={line['tok_s']:.0f}")
            lines.append(line)
    return {"rewards": torch.stack(rewards).cpu().tolist(), "lines": lines,
            "metrics": m, "seconds": time.time() - t0,
            "params": cfg.param_count()}


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 32      # phases 1, 2 and 32 alone
    python3 chip_smoke.py --phase 33      # phases 1, 2 and 33 alone
    python3 chip_smoke.py --phase 34      # phases 1, 2 and 34 alone


Phases, each printing JSON lines; any failed check raises and the script
exits nonzero without printing a result:

  1. device   the card (nvidia-smi name and power limit), torch and CUDA
  2. build    nvcc builds every kernel from csrc/, one process per source,
              all started together (ptxas registers and spills of every
              kernel function, seconds; a spill in V-trace fails); 2b
              each kernel's Python launch geometry (ops.launch_geometry,
              which python -m repro_torch.analysis audits) equal to its
              .cu's own at phase 3's shapes and every audited launch
  3. kernel   each kernel against its plain PyTorch version on the card:
              V-trace at the trainer's and the paper's shapes, one
              launch's floor (1, 1) and a long unroll past the L2; flash
              attention at Qwen3-4B's prefill shapes, a windowed and
              softcapped case, head_dim 64 and 256, and Zamba2's shared
              block (head_dim 80); decode attention at the serving shapes
              of both; then both at the LM trainers' shapes (phases 15,
              16), at Granite-3.0-1B-A400M's (phases 19–21: 16 query
              heads over 8 KV heads, head_dim 64) and at
              Llama-3.2-Vision-90B's (phase 25: 64 query heads over 8, a
              300-token prompt and a 364-slot cache) and at one model
              rank's of phase 26 (half the heads) and at phase 32's
              families (a group of 7, 4,096-slot rings wrapped, softcap
              50, hd 64 at group 1); K2 with its queries
              offset from the keys (FLASH_OFFSET_SHAPES, SDPA with the
              positions' mask as the library); each in bf16 and
              float32, with events and graph times,
              bounds and the share of them reached, SDPA's events and
              graph times, the wrapper's host time per call, and the split
              count decode attention launched with; the SSD chunk at a
              Zamba2-2.7B admission (80 heads sharing B/C, N = P = 64), 8
              rows, ragged lengths, the reference's sweep and one model
              rank's chunk of phase 26a (40 heads)
  4. learner  three learner steps of the IMPALA deep ResNet at full width
              (84x84x4 obs, 18 actions, T=80, B=32, Table G.1 RMSProp) on a
              seeded synthetic rollout, held against the plain-loop V-trace
  4b. replay_learner  five such steps on replay's mixed batches: a
              ReplaySource (elite, 64 rollouts, ratio 1.0, the baseline as
              value_fn) over a seeded synthetic full-width source, B 32
              fresh + 32 replayed, CLEAR costs 0.01 / 0.005; one V-trace
              launch a step at (80, 64), the first loss held against the
              plain-loop V-trace; next_batch split (inner, to_host,
              sample, insert, to_device), value_fn and learner ms, peak
              memory, bytes per step
  5. trainer  repro_torch.launch.train.main on gridworld with the deep agent
              (the rl-agent main path: its V-trace launches are reported)
  5b. replay_trainer  the same run with --replay elite (the learner at B
              64), its V-trace launches; then whether replay's host copy
              waited for the unroll left in flight (CUDA events)
  6. converge Catch with the quickstart settings must reach "SOLVED"
  6b. replay_example  the reference's example, Catch --replay elite
              --replay-ratio 1.0 --steps 500: its final reward/step
  7. host     repro_torch.launch.train.main with --actors host (8 actor
              threads stepping gridworld on the CPU, the deep agent's
              policy batched on the card, a CUDA graph per padded batch:
              31b's checks run here; the learner's V-trace launches
              reported); no inference or actor thread may outlive main
  7b. replay_host  the same with --replay uniform
  8. resume   Catch with the minatar agent, cuDNN pinned deterministic:
              two uninterrupted 12-step runs, a run crashed at step 7 and
              resumed from its crash checkpoint, and a CLI run checkpointed
              every 6 steps and resumed from step 6, each bitwise equal to
              the uninterrupted run's final params and optimizer state;
              then the checkpoint's bytes and the times of snapshot and
              write; then all of it again with --replay elite, the replay
              buffer, its sampling generator and feedback bookkeeping
              bitwise too (8b)
  9. model    Qwen3-4B at full width in float32, weights from seed 0: the
              kernel attention path against the plain (dense) path on 4
              prompts of 300 tokens and 16 teacher-forced decode steps
 10. serve    repro_torch.launch.serve.main at full Qwen3-4B width in bf16
              with --attn-impl kernel, 24 requests (the serving main path:
              its flash- and decode-attention launches are reported); then
              a profile of one decode step (host time, device busy time by
              kernel; at 9 of the 36 groups, PROFILE_GROUPS)
 11. zamba    Zamba2-2.7B as published in float32, weights from seed 0: the
              kernel path (SSD chunk and attention kernels) against the
              plain path on 4 prompts of 512 tokens (two chunks, the state
              carried through the kernel) and 16 teacher-forced steps
 12. zserve   repro_torch.launch.serve.main at full Zamba2-2.7B width with
              --attn-impl kernel --ssd-impl kernel, 24 requests of 1..256
              tokens (its SSD chunk, flash- and decode-attention launches
              are reported); then a profile of one decode step (3 of
              the 9 groups)
 13. grad     gradients on the card, float32: one full-width Zamba2-2.7B
              Mamba2 layer on a 256-token chunk and one full-width Qwen3-4B
              attention layer at S 512, the loss mean(out^2) through the
              kernel paths (kernel forward, the plain version's VJP
              backward) against the plain paths, on the output, the input
              and every parameter, within MODEL_TOL
 15. lm_rl    repro_torch.launch.train.main --mode lm-rl at full Qwen3-4B
              width (bf16 activations on float32 weights, AdamW, remat):
              1 step of 8 episodes of 64 tokens from the decode session
              (K2 in each prefill, K3 in every layer of every step), the
              learner through K2 under autograd and K1; ms per step split
              into next_batch (generation) and the learner, fps, peak
              memory, launches against layers x steps; then one float32
              step on a batch of the run, kernel paths against plain
              paths: the kernel path's launches exact, loss and gradient
              norm within MODEL_TOL, each parameter's gradient within
              LM_GRAD_TOL of its largest
 16. lm       --mode lm at full Zamba2-2.7B width: 1 step of 4 x 512
              tokens, K4 in every Mamba2 layer (two chunks) and K2 in the
              shared block under autograd (remat: per group, and per layer
              inside Zamba2's six-layer groups); tok/s, ms per step, peak
              memory, launches against layers x chunks x passes; then the
              same float32 check
 17. dp       data parallel (--mesh-data), cuDNN pinned deterministic:
              17a world size 1 through NCCL in this process, 3 steps of
              phase 4's learner and batch, losses and learner state
              bitwise the plain step's, K1 once a step at (80, 32), ms a
              step beside the plain step's and a gradient all-reduce's
              ms; 17b two ranks sharing the card through gloo (rank 1
              spawned), B 16 each, the first loss within 1e-5 of 17a's
              and the later ones within that or twice the gap a reversed
              batch gives the plain step (17a), both ranks' state
              bitwise equal, K1 once a step a rank at (80,
              16), gloo's staging times (not a speed figure); 17c
              train.main --mesh-data 1 on phase 5's run, with --replay
              elite and with --actors host, K1 launches = steps; 17d
              phase 8's CLI resume with --mesh-data 1, bitwise (learner
              and sharded source state; the learner state also the
              single-process run's)
 18. recurrent  the LSTM agent (TorchBeast's core_state API): 18a on
              Catch, B 32, T 20, 3 unrolls on the card each followed by a
              learner step through K1 (the learner's re-run of the cell
              within 1e-5 of the behaviour logits, one launch a step);
              18b at full width (84x84x4, 18 actions, T 80, B 32, Table
              G.1 RMSProp), 3 learner steps on a seeded synthetic
              recurrent rollout, the first loss against the plain-loop
              V-trace within 1e-4; ms a step, peak memory
 19. granite  phase 9 for Granite-3.0-1B-A400M (MoE, 32 experts top-8):
              4 prompts of 256 tokens (two 512-token routing groups) and
              16 teacher-forced steps, kernel against plain path: logits
              within 1e-3, and every token routed to the same set of
              experts by both paths (tokens routed differently counted
              and printed with their top-k margins)
 20. gserve   phase 10 for Granite in bf16: 24 requests of up to 64 tokens
              in 8 slots, K2/K3 launches against layers x admissions and
              layers x steps, and the MoE layers' mean dropped fraction
              at decode and at admission
 21. glm_rl   phase 15 for Granite (K1 at (64, 8), K2, K3 exact; the
              router's load-balance and z-loss of the trained weights),
              with its float32 kernel-against-plain step; then 2 steps of
              --mode lm at B 4, S 512 (K2 under remat, the router losses)
              and its float32 step
 22. xlstm    xLSTM-125M at full width (12 layers, d 768, 4 heads of 192,
              chunk 64) in float32, weights from seed 0: the forward of 4
              x 512 tokens (8 mLSTM chunks) against a prefill of 448
              tokens and 64 teacher-forced decode steps, on seeds 0 and
              1: logits at those 64 positions within XLSTM_LOGIT_RTOL of
              their largest, each mixer alone within XLSTM_LAYER_RTOL of
              its output's, each layer's gap reported; one mLSTM layer,
              chunkwise mlstm_apply against the sequential
              mlstm_reference on 512 tokens within XLSTM_TOL; no kernel
              launched (the mixers are plain PyTorch, as the reference's)
 23. xserve   repro_torch.launch.serve.main for xLSTM-125M in bf16: 24
              requests of 1..64 tokens (one chunk at most) in 8 slots, no
              kernel launched; then a profile of one decode step (2 of
              the 6 groups)
 24. xlm_rl   --mode lm-rl for xLSTM-125M, B 8, T 64, 3 steps: K1 once a
              step at (64, 8), nothing else; ms a step split into
              generation and learner, fps, peak memory; its float32
              kernel-against-plain step (only V-trace differs); then 1
              step of --mode lm at B 4, S 128 (the sLSTM's 128-step loop
              under remat, no kernel), tok/s
 25. vlm      Llama-3.2-Vision-90B at every published width, depth cut
              from 20 groups to VLM_GROUPS (4 self-attention layers and
              one cross-attention layer: 6,379,634,688 parameters), the
              vision stub (4 x 6,144 positions) drawn from a seeded
              generator: float32 kernel path (K2 in the self-attention
              layers, xattn plain) against the plain path on 4 prompts
              of 300 tokens and 16 teacher-forced steps (K2 4, K3 4 x 16,
              logits within MODEL_TOL); bf16 generate(vision=) at B 4,
              300-token prompts, 64 tokens (K2 4, K3 4 x 63, prefill ms,
              ms a decode step, peak memory); then 2 steps of --mode lm
              on the reduced config (an AdamW step of one full-width group
              needs about 102 GB), K2 exact, and its float32
              kernel-against-plain step with the seeded vision stub
 26. mp       --mesh-model 2, the ranks sharing cuda:0 through gloo (NCCL
              refuses two ranks on one device; the times are checks of
              the collectives, not speed figures): 26a Zamba2-2.7B --mode
              lm and 26b Granite-3.0-1B-A400M --mode lm-rl at full width,
              depth cut to MP_GROUPS (1 of 9 and 2 of 24 groups),
              through the entry point's builders and Runtime, each rank's
              losses, step ms, model-group all-reduces and peak memory,
              K1-K4 launches exact a rank (the unmeshed run's counts),
              the ranks' losses and tokens equal, and one float32 step of
              each rank at full width, depth cut (MP_F32_GROUPS), against
              the single-process step on the same weights (loss and norm
              within MODEL_TOL, each leaf's slice within LM_GRAD_TOL;
              Granite's routing pinned); 26c reduced Qwen3-4B on (2, 2),
              four ranks, both LM modes, each step within MP_TOL of the
              unmeshed one; 26d a reduced --mode lm --mesh-model 2 run
              (train._train's ranks on the card; the killed leg in a
              process of its own, MP_CLI) SIGKILLed after its step-3
              checkpoint and resumed, bitwise the uninterrupted run, then
              that checkpoint restored at (2, 1) and (1, 1), every leaf
              bitwise, the next step's losses within MP_TOL
 27. slice14  the model axis for the xLSTM mixers and xattn, and the
              other rules tables, ranks sharing cuda:0 through gloo: 27a
              xLSTM-125M --mesh-model 2 (1 of its 6 groups, MP_GROUPS)
              through the trainer's builders
              (lm-rl, K1 once a step; lm), each with its float32 step against
              the single-process one (XLSTM_GRAD_TOL), and Server(mesh=):
              float32 teacher-forced logits against the unmeshed session,
              MP_SERVE_REQUESTS bf16 requests of 1..64 tokens, the
              ranks' outputs equal;
              27b one Llama-3.2-Vision-90B group at (1, 2): 32 of 64
              query heads a rank, float32 kernel against plain path (K2
              4), bf16 generate(vision=) (K2 4, K3 4 x 15); 27c the
              launch/specs.py programs at full width in float32
              (SPEC_RUNS: Granite expert_seqpar train (2 of 24 groups)
              and expert decode (4), Zamba2-2.7B seqpar train (1 of 9)
              at (1, 2), one Qwen3-32B group fsdp_seqpar train and fsdp
              decode at (2, 2), each InputShape cut and its bytes
              reckoned beforehand): launches a rank
              against the layer count, step ms, peak memory, collectives
              by group and kind, ZeRO-1 state held, and each rank's
              gradient slices (ZeRO-2's) or logits against the same
              program on one rank; 27d python -m
              repro_torch.launch.multihost --mode serve as two
              --coordinator processes (MH_ARGV)
 28. slice15  28a train.main --mode rl-agent --mesh-data 2 as two
              --coordinator processes sharing cuda:0 through gloo (Catch,
              MH_RL_ARGV), against the same command's ranks spawned onto
              the card as 17b spawns its ranks: step lines, final loss
              and final checkpoint bitwise, K1 once a step in each
              process; 28b the cp_fsdp_seqpar specs program (CP_SPEC_RUN:
              Qwen3-4B at every published width, 2 of 36 groups, float32,
              (1, 2)), each rank's queries at their offset in K2, checked
              as 27c's runs; 28c python -m repro_torch.launch.dryrun on
              the card (DRYRUN_ARGV: one step of the program and of its
              block program, peak memory) and its modelled 16x16 report
 29. graph    slice 16, the compiled decode step (session_fns: a CUDA
              graph of model.serve_step a state's static buffers) at full
              width against eager steps from the same state, every
              product bitwise (logits, baseline, each cache leaf, token,
              log-prob, entropy, the step's baseline): the Qwen3-4B (9
              of 36 groups), Zamba2-2.7B (3 of 9), Granite (12 of 24)
              and xLSTM-125M 8-slot sessions in
              bf16 (GRAPH_SESSIONS; one capture, K3 a replay equal to an
              eager step's, an in-place SGD step of the weights read by
              the next replay with no new capture; xLSTM also another
              params module, one more capture), eager and graph ms a
              step in turns, one replay's device ms, the graph step's
              idle share under torch.profiler; one Llama-3.2-Vision-90B
              group's generate(vision=) (phase 25's shapes) and its
              eager loop; Granite lm-rl generation (8 of 24 groups)
              through GeneratorSource (B 8, T 64), two batches around an
              in-place weight update, against the same episodes
              generated eagerly, one capture. Phases 10, 12, 15, 20-25
              decode through the graphs too, their checks unchanged
 30. graph    slice 17 (core/compiled.py), graph against eager from one
              state, bitwise (or within twice a second eager run's gap):
              30a the full-width learner steps (deep, recurrent), 30b the
              pipelined unroll (gridworld, Catch), 30c the Qwen3-4B (9
              of 36 groups) and Zamba2-2.7B (3 of 9) admissions; phases
              4-8, 17, 18 run through them
 31. graph    slice 18: 31a the LM learner steps at full width through
              the compiled.TrainStep that train.build_lm_rl / build_lm
              build, against the plain step from the built state, 3
              steps (warm, capture, replay; AdamW's scalars new each
              step) on batches the built source draws: Qwen3-4B lm-rl (B
              8, T 64; K1, K2) and Zamba2-2.7B lm (4 x 512; K2, K4), their
              kept states in host memory, Granite lm-rl (MoE), xLSTM-125M
              lm (S 128; Qwen3-4B at 9 of 36 groups, Zamba2 at 3 of 9,
              Granite at 8 of 24, the xLSTM at 2 of 6) and the reduced
              VLM lm; every metric,
              parameter
              and AdamW leaf bitwise (or within twice a second eager
              run's gap), one capture, each step's K1/K2/K4 launches
              remat_step_launches' in both runs, ms a step and peak
              memory of each run; 31b phase 7's host actors, the policy a
              CUDA graph per padded batch (compiled.Forward, captured on
              the inference thread), each bucket (1, 2, 4, 8) bitwise the
              eager forward with one capture a bucket, a replay after
              _sync reading the new weights, ms a host step and a policy
              call; 31c replay's value function bitwise the eager
              baseline, one capture across a weight update; 31d (in
              phase 29's VLM group) generate(vision=)'s prefill through
              its admission graph, one capture a key, bitwise eager. The
              LM phases 15, 16, 21, 24, 25 replay their learner graphs
              (their compiled: line, one capture, the graph pools
              released before each float32 check)
 32. family   slice 19, the families of configs/ no earlier phase runs
              (FAMILY_MODELS), at every published width, weights from
              seed 0: 32a phase 9's check in float32 (logits within
              MODEL_TOL, K2 and K3 launches exact, peak memory):
              Gemma2-27B on 4 of 23 groups, B 1, a 4,160-token prompt
              (its 4,096-slot local rings wrap in the prefill) and the
              final softcap over 256,000 logits; Mixtral-8x7B on 4 of 32
              groups, B 1, 4,608 tokens (9 MoE groups of 512), no token
              routed to another expert set; DeepSeek-Coder-33B on 8 of
              62 groups (56 query heads over 8), B 4 x 512; MusicGen-Large
              on 24 of 48 layers, B 4 x 512; 32b each served in bf16
              (phase 10's checks; at 32a's depth through serve.run,
              MusicGen-Large 24 requests, the others 12; prompts of up
              to 512 tokens, 64 generated, 8
              slots) and its compiled decode step held bitwise against
              eager (phase 29's check, one capture)
 33. family_train  slice 20, the same four families trained at every
              published width through train.main (FAMILY_TRAIN, depth cut
              by depth_cut: Gemma2-27B and Mixtral-8x7B lm-rl at 2
              groups, where weights, gradients and AdamW moments come near
              Qwen3-4B's 64 GB, their lm at 1, DeepSeek-Coder-33B at 3 of
              62, MusicGen-Large at 12 of 48): --mode lm-rl (B 8, T 64;
              K3 generation, K2 prefill and learner, K1) and --mode lm
              (Gemma2-27B and Mixtral-8x7B B 1 x 5,120 tokens, past their
              4,096-token windows; DeepSeek-Coder-33B and MusicGen-Large
              B 4 x 512), 1 step each, with phases 15 and
              16's checks (the compiled: line, one capture, memory
              released, launches exact, a float32 kernel-against-plain
              step with every metric and, for Mixtral, the router's
              terms and flips on pinned routes), then 31a's check of the
              same run (graph against eager, 3 steps, one capture); run
              right after phase 3, on a card no other phase has left
              memory on
 34. examples  slice 21, the repository's five examples on the port
              (src/repro_torch/examples), each through its main, its
              launches exact: 34a quickstart (3 host-actor steps, then
              Catch to "SOLVED"; K1 3 + 1,500); 34b the V-trace ablation
              at one seed (700 steps, lag 40; K1 2,800), then the
              uncorrected arm's log rho exactly 0, its user-written step
              captured by compiled.TrainStep bitwise eager, and the lagged
              actors' copy refreshed only every 3rd step under the unroll
              graph; 34c the gridworld (300 steps, its fps), its unroll
              and learner step one graph (compiled.UnrollTrainStep)
              bitwise eager; 34d lm_rl_100m at its default width (d 640,
              16 layers) with vocab 256, 100 steps (the reward curve; K1
              100, K2 3,200, K3 49,600), one learner graph step bitwise
              eager, generation and learner ms; 34e serve_batched (its
              DeprecationWarning, the reduced Qwen3-4B server, K2/K3
              exact)
 14. kernels  one {"kernels": [...]} line (K1's lm_rl_* fields: its (64, 8)
              row; lm_rl_launches / lm_launches: phases 15 and 16; dp_*:
              phase 17's launches; recurrent_*: phase 18's; granite_*:
              phases 20 and 21's; xlstm_*: phase 24's; vlm_*: phase
              25's; mp_*: phase 26's, one entry a rank;
              slice14_launches / slice15_launches: phase 27's and 28's
              runs, a rank each; slice17_launches / slice18_launches /
              slice19_launches / slice20_launches: phases 30, 31a, 32b
              and 33; slice21_launches: phase 34, an example each; K2's
              offset_*: phase 3's offset row),
              then
              the card's name and power limit, then the final
              {"ok": true, "device": {...}} line

It needs CUDA and the repository's src/ beside it; it exits nonzero when
either is missing. Times are CUDA-event or synchronised host-clock times
taken in this run, on the card named in phase 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

_T0 = time.perf_counter()
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# (the card's peaks, and the bound every kernel row reads, are the port's:
# repro_torch/launch/mesh.py and launch/roofline.py::bound)
VTRACE_TOL = 1e-5              # expf rounding compounds through <=200 FMAs
# (T, B): the learner's and the trainer's, one launch's floor (1, 1), a
# ragged B, and two at a long unroll: (200, 4096) moves 19.7 MB, which
# stays in the 50 MB L2 across graph replays, (200, 16384) 78.7 MB, which
# does not
VTRACE_SHAPES = [(80, 32), (20, 32), (1, 1), (33, 200), (200, 4096),
                 (200, 16384)]
# the learner's and the trainer's with replay's mixed batches (B fresh + B
# replayed columns). Phase 3 draws a shape's inputs from seed 1000 + its
# index in VTRACE_SHAPES + REPLAY_VTRACE_SHAPES, so these come after the
# others, whose seeds tests/test_torch_vtrace_designs.py shares
REPLAY_VTRACE_SHAPES = [(80, 64), (20, 64)]
# the lm-rl learner's (T = --seq, B = --batch), after those for the same
# reason
LM_RL_VTRACE_SHAPES = [(64, 8)]
TRAINER_SHAPE = (20, 32)       # (T, B) of the phase-5 main path
LM_RL_SHAPE = (64, 8)          # (T, B) of the phase-15 learner
REPLAY_SHAPE = (80, 64)        # (T, B) of the full-width replay learner
VTRACE_FLOOR = (1, 1)          # one thread, one row: a launch's floor
# float operations per (t, b) element of the fused kernel: 3 clips, delta
# (4), recurrence (3), vs (1), pg-advantage (4); the expf counts as one
VTRACE_FLOPS_PER_ELEM = 15

ATTN_TOL = 2e-5                # float32, as tests/test_kernels.py holds them
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
# (B, H, K, S, hd, window, softcap): Qwen3-4B prefill (32 query heads over
# 8 KV heads, hd 128) at bucket and exact prompt lengths, a gemma2-like
# windowed and softcapped case, and the other two head_dims; then, after
# those so that no earlier seed moves, the LM trainers' own: the lm-rl
# prefill of 8 one-token prompts (bucket 1), its learner's forward (B 8,
# S = --seq 64), and Zamba2's shared block in --mode lm (B 4, S 512);
# then Granite's (16 query heads over 8 KV heads, hd 64): a 256-token
# prompt and a server admission of 8 prompts of 64; then the VLM's
# self-attention prefill (64 query heads over 8, phase 25's 4 x 300); last,
# the reduced VLM's --mode lm (4 query heads over 2, hd 64, B 4, S 64);
# then one model rank's of phase 26 (half the heads): Zamba2's shared
# block in --mode lm, Granite's lm-rl prefill (bucket 1) and learner;
# then one rank's of phase 27: the VLM group's prefill (27b, B 4 and the
# float32 check's B 2), and the specs programs' training (27c: Granite,
# Zamba2's shared block, Qwen3-32B at data 2 x model 2); last, phase 32's
# families: a Gemma2-27B global layer (softcap 50; its local layer is the
# windowed row above), Mixtral-8x7B (window 4096 over a 4,608-token
# prompt), DeepSeek-Coder-33B (56 query heads over 8: a group of 7) and
# MusicGen-Large (MHA, hd 64)
FLASH_SHAPES = [(1, 32, 8, s, 128, 0, 0.0) for s in (1, 16, 256, 300, 512)] \
    + [(1, 32, 16, 4608, 128, 4096, 50.0), (1, 8, 2, 256, 64, 0, 0.0),
       (1, 8, 2, 256, 256, 0, 0.0), (1, 32, 32, 256, 80, 0, 0.0)] \
    + [(8, 32, 8, 1, 128, 0, 0.0), (8, 32, 8, 64, 128, 0, 0.0),
       (4, 32, 32, 512, 80, 0, 0.0)] \
    + [(1, 16, 8, 256, 64, 0, 0.0), (8, 16, 8, 64, 64, 0, 0.0)] \
    + [(4, 64, 8, 300, 128, 0, 0.0), (4, 4, 2, 64, 64, 0, 0.0)] \
    + [(4, 16, 16, 512, 80, 0, 0.0), (8, 8, 4, 1, 64, 0, 0.0),
       (8, 8, 4, 64, 64, 0, 0.0)] \
    + [(4, 32, 4, 300, 128, 0, 0.0), (2, 32, 4, 300, 128, 0, 0.0),
       (4, 8, 4, 256, 64, 0, 0.0), (2, 16, 16, 512, 80, 0, 0.0),
       (1, 32, 4, 256, 128, 0, 0.0)] \
    + [(1, 32, 16, 512, 128, 0, 50.0), (1, 32, 8, 4608, 128, 4096, 0.0),
       (1, 56, 8, 512, 128, 0, 0.0), (1, 32, 32, 512, 64, 0, 0.0)]
FLASH_MAIN = ((1, 32, 8, 512, 128, 0, 0.0), "bfloat16")
# (B, H, K, cap, hd, pos, window, softcap): the serving decode (8 slots at
# their own positions in 576-slot caches), scalar pos, 4096-slot caches, a
# ring buffer with window 32, softcap; Zamba2's shared block (no GQA, hd
# 80, 8 slots of 320); the lm-rl episodes' 65-slot caches (--seq + 1:
# ranges of 32, 32 and a ragged 1); Granite's decode (16 query heads over
# 8 KV heads, hd 64) in 576-slot caches; last, the VLM's (64 over 8) in
# phase 25's 364-slot caches (300-token prompts + 64); then one model
# rank's of phase 26b: Granite's lm-rl episodes on 8 of 16 query heads;
# then one rank's of phase 27: the VLM group's generate (32 over 4 heads,
# 316 slots), Granite's and Qwen3-32B's decode programs (27c); last, phase
# 32's families: a Gemma2-27B local layer's 4,096-slot ring (positions
# past 4,096: wrapped) and a global layer, both softcapped at 50,
# Mixtral-8x7B's ring, DeepSeek-Coder-33B's group of 7 and MusicGen-Large
# (group 1 at hd 64)
DECODE_SHAPES = [(8, 32, 8, 576, 128, "rows", 0, 0.0),
                 (8, 32, 8, 576, 128, "scalar", 0, 0.0),
                 (8, 32, 8, 4096, 128, "rows", 0, 0.0),
                 (8, 32, 8, 4096, 128, "scalar", 0, 0.0),
                 (8, 32, 8, 32, 128, "ring", 32, 0.0),
                 (8, 32, 8, 576, 128, "rows", 0, 50.0),
                 (8, 32, 32, 320, 80, "rows", 0, 0.0),
                 (8, 32, 8, 65, 128, "rows", 0, 0.0),
                 (8, 16, 8, 576, 64, "rows", 0, 0.0),
                 (4, 64, 8, 364, 128, "rows", 0, 0.0),
                 (8, 8, 4, 65, 64, "rows", 0, 0.0),
                 (4, 32, 4, 316, 128, "rows", 0, 0.0),
                 (8, 8, 4, 64, 64, "scalar", 0, 0.0),
                 (2, 32, 4, 64, 128, "scalar", 0, 0.0),
                 (8, 32, 16, 4096, 128, "ring", 4096, 50.0),
                 (8, 32, 16, 576, 128, "rows", 0, 50.0),
                 (8, 32, 8, 4096, 128, "ring", 4096, 0.0),
                 (8, 56, 8, 576, 128, "rows", 0, 0.0),
                 (8, 32, 32, 576, 64, "rows", 0, 0.0)]
DECODE_MAIN = ((8, 32, 8, 576, 128, "rows", 0, 0.0), "bfloat16")
# (slices, L, N, P, heads, decay): heads > 1 is the model's layout, one B/C
# group per batch row read by all its heads; da = -U(0, decay) per step.
# One Zamba2-2.7B admission of a whole 256-token chunk (80 heads, N = P =
# 64; decay 0.55 takes acs to about -70, as at full width), the same for
# 8 rows, ragged admissions, the same admission in the reference's layout
# (B/C repeated per head), then the reference's sweep (tests/test_kernels.py);
# then one model rank's chunk of phase 26a (B 4 x 40 of the 80 heads);
# last, one rank's of phase 27c's Zamba2 program (B 2 x 40 heads, the
# training chunk of 128)
SSD_SHAPES = [(80, 256, 64, 64, 80, 0.55), (640, 256, 64, 64, 80, 0.55),
              (80, 1, 64, 64, 80, 0.55), (80, 37, 64, 64, 80, 0.55),
              (80, 255, 64, 64, 80, 0.55), (80, 256, 64, 64, 1, 0.55),
              (4, 64, 32, 32, 1, 0.1), (2, 128, 64, 64, 1, 0.1),
              (1, 128, 128, 64, 1, 0.1), (3, 96, 64, 32, 1, 0.1),
              (160, 256, 64, 64, 40, 0.55), (80, 128, 64, 64, 40, 0.55)]
SSD_MAIN = (80, 256, 64, 64, 80, 0.55)
MODEL_TOL = 1e-3               # full-width logits, kernel vs dense path
# one float32 LM learner step, kernel vs plain paths: each leaf's largest
# gradient difference over that leaf's largest gradient; about five times
# the largest measured on an H100 (4.1e-5, a Zamba2 dt_bias; PERF.md)
LM_GRAD_TOL = 2e-4
LM_SPLIT_REPS = 1              # timed next_batch / learner calls after a run
# what an LM run may leave reserved on the card once its runtime is freed
# (its learner graph's pool and the session's must be released): the
# cuBLAS workspaces of the capture streams stay
LM_RELEASED_BYTES = 1 << 30
SERVE_ARGV = ["--arch", "qwen3-4b", "--attn-impl", "kernel", "--requests",
              "24", "--prompt-len", "512", "--gen-tokens", "64",
              "--max-batch", "8"]
HOST_STEPS = 4
HOST_ARGV = ["--mode", "rl-agent", "--actors", "host", "--env", "gridworld",
             "--agent", "deep", "--batch", "32", "--steps", str(HOST_STEPS)]
# the resume phase's run: Catch, the minatar agent, the quickstart settings
RESUME_ARGV = ["--mode", "rl-agent", "--env", "catch", "--agent", "minatar",
               "--batch", "32", "--lr", "2e-3"]
RESUME_STEPS, CRASH_STEP, CKPT_EVERY, CLI_EVERY = 12, 7, 4, 6
# its replay leg: 12 steps insert 384 rollouts, so a 256-rollout buffer
# has written every slot (the bytes compared) and evicted by the end
RESUME_REPLAY_ARGV = ["--replay", "elite", "--replay-capacity", "256"]
TRAINER_ARGV = ["--mode", "rl-agent", "--env", "gridworld", "--agent", "deep",
                "--batch", "32", "--steps", "20"]
# replay: the reference's example (repro.launch.train's docstring), and
# the full-width learner's buffer, cut from the reference's default 512
# rollouts (4.68 GB of host memory at 84x84x4, T 80) to 64 (585 MB)
REPLAY_EXAMPLE_ARGV = ["--mode", "rl-agent", "--env", "catch", "--replay",
                       "elite", "--replay-ratio", "1.0", "--steps", "500"]
REPLAY_LEARNER_STEPS, REPLAY_LEARNER_CAPACITY = 5, 64
# phase 17, data parallel: learner steps of 17a/17b, 17b's bar against
# 17a, and the (T, B) each rank's V-trace runs at in 17a and 17b. The
# bar is DP_RTOL / DP_ATOL, widened after the first update to
# DP_REORDER_FACTOR times the gap that reversing the batch's columns
# gives the plain step (17a measures it): Table G.1's learner on one
# repeated random batch grows its loss 33x in two steps, and a reorder
# of its float32 sums alone then moves the third loss by about 2e-5
DP_STEPS = 3
DP_RTOL, DP_ATOL = 1e-5, 1e-6
DP_REORDER_FACTOR = 2.0
DP_SHAPE, DP2_SHAPE = (80, 32), (80, 16)
ZAMBA_SERVE_ARGV = ["--arch", "zamba2-2.7b", "--attn-impl", "kernel",
                    "--ssd-impl", "kernel", "--requests", "24",
                    "--prompt-len", "256", "--gen-tokens", "64",
                    "--max-batch", "8"]
# phase 18: learner steps of each part
RECURRENT_STEPS = 3
# phases 19-21: Granite-3.0-1B-A400M's server (24 requests of up to 64
# tokens in 8 slots, as phase 10), lm-rl as phase 15, and 2 --mode lm
# steps of 4 x 512 tokens (four 512-token MoE groups a layer)
GRANITE = "granite-moe-1b-a400m"
GSERVE_ARGV = ["--arch", GRANITE, "--attn-impl", "kernel", "--requests",
               "24", "--prompt-len", "64", "--gen-tokens", "64",
               "--max-batch", "8"]
GLM_RL_ARGV = ["--mode", "lm-rl", "--arch", GRANITE, "--attn-impl",
               "kernel", "--vtrace-impl", "kernel", "--batch", "8", "--seq",
               "64", "--steps", "1"]
GLM_ARGV = ["--mode", "lm", "--arch", GRANITE, "--attn-impl", "kernel",
            "--batch", "4", "--seq", "512", "--steps", "2"]
# phases 22-24: xLSTM-125M (no kernel in its mixers). The server takes
# prompts of at most one 64-token chunk; lm-rl as phase 15; --mode lm at
# S 128 runs the sLSTM's 128-step loop over two mLSTM chunks (PERF.md
# section 4 lists the depths cut for the script's time). XLSTM_TOL:
# chunkwise mLSTM against its sequential oracle at full width (the
# reference's own test holds them at 2e-4 at reduced width)
XLSTM = "xlstm-125m"
XLSTM_TOL = 1e-4
# phase 22's prefill + decode against the forward, each gap over its
# output's largest magnitude: the logits (read on an H100: 1.35e-4 and
# 5.2e-5 for seeds 0 and 1, the rounding of 12 recurrent layers
# compounded), and each mixer alone on the forward's input to it (at most
# 1.84e-5, an mLSTM; PERF.md)
XLSTM_LOGIT_RTOL = 4e-4
XLSTM_LAYER_RTOL = 1e-4
XSERVE_ARGV = ["--arch", XLSTM, "--requests", "24", "--prompt-len", "64",
               "--gen-tokens", "64", "--max-batch", "8"]
XLM_RL_ARGV = ["--mode", "lm-rl", "--arch", XLSTM, "--vtrace-impl",
               "kernel", "--batch", "8", "--seq", "64", "--steps", "3"]
XLM_ARGV = ["--mode", "lm", "--arch", XLSTM, "--batch", "4", "--seq", "128",
            "--steps", "1"]
# phase 25: Llama-3.2-Vision-90B, one of its 20 groups at every published
# width (25.5 GB of float32 weights; all 20 are 351 GB), and its training
# on the reduced config
VLM = "llama-3.2-vision-90b"
VLM_GROUPS = 1
VLM_PROMPT, VLM_GEN = 300, 64
VLM_LM_ARGV = ["--mode", "lm", "--arch", VLM, "--reduced", "--attn-impl",
               "kernel", "--batch", "4", "--seq", "64", "--steps", "2"]
# phase 26, model parallel: two ranks share the card through gloo. 26a
# Zamba2-2.7B --mode lm, 26b Granite lm-rl at full width, each with one
# float32 step at MP_F32_GROUPS groups (full width, depth cut: each rank
# also runs the single-process step it is held to); 26c reduced Qwen3-4B
# on (2, 2); 26d the checkpoint run, killed and resumed, and its elastic
# restores
ZMP_ARGV = ["--mode", "lm", "--arch", "zamba2-2.7b", "--attn-impl",
            "kernel", "--ssd-impl", "kernel", "--batch", "4", "--seq",
            "512", "--steps", "1", "--mesh-model", "2"]
GMP_ARGV = ["--mode", "lm-rl", "--arch", GRANITE, "--attn-impl", "kernel",
            "--vtrace-impl", "kernel", "--batch", "8", "--seq", "64",
            "--steps", "1", "--mesh-model", "2"]
MP_F32_GROUPS = {"zamba2-2.7b": 1, GRANITE: 2}
# the depth of 26a, 26b and 27a's runs (full width, depth cut from the
# published 9, 24 and 6 groups for the script's time): a rank's gloo
# collectives grow with the layers, and the checks hold per layer
MP_GROUPS = {"zamba2-2.7b": 1, GRANITE: 2, XLSTM: 1}
MP22_STEPS = 2
MP_TOL = 1e-5
MP_CKPT_ARGV = ["--mode", "lm", "--arch", "qwen3-4b", "--reduced",
                "--batch", "8", "--seq", "32", "--steps", "6"]
# phase 27: 27a xLSTM-125M at (1, 2) through the trainer (--mesh-model 2;
# the float32 step at XMP_F32_GROUPS of its 6 groups) and
# Server(mesh=); 27b one of
# Llama-3.2-Vision-90B's groups at (1, 2); 27c the launch/specs.py
# programs at full width (float32) under the tables resolve_rules picks
# (SPEC_RUNS: each InputShape cut from the named one, see reduced_from;
# "bytes" is the reckoning written before the run); 27d the multihost
# entry point as two --coordinator processes
XMP_RL_ARGV = ["--mode", "lm-rl", "--arch", XLSTM, "--vtrace-impl", "kernel",
               "--batch", "8", "--seq", "32", "--steps", "1",
               "--mesh-model", "2"]
XMP_LM_ARGV = ["--mode", "lm", "--arch", XLSTM, "--batch", "4", "--seq",
               "64", "--steps", "1", "--mesh-model", "2"]
XMP_F32_GROUPS = 1
# the xLSTM's float32 step gradients carry more rounding than the other
# archs' (exp-gated recurrences over 12 layers): at full width on the CPU
# (tests/xlstm_grad_gap.py: B 8, T 64, lm-rl, seed 0) the port's unmeshed
# gradient lies 1.23e-4 of a leaf's largest from the JAX reference's and
# the (1, 2) mesh's 3.13e-4, so its meshed step is held to 1e-3, not
# LM_GRAD_TOL
XLSTM_GRAD_TOL = 1e-3
MP_SERVE_LENS, MP_SERVE_STEPS, MP_SERVE_RTOL = (1, 20, 47, 64), 8, 1e-4
MP_SERVE_REQUESTS, MP_SERVE_TOKENS = 6, 8
MP_VLM_GEN = 16
SPEC_RUNS = (
    dict(phase="spec_granite_train", arch=GRANITE, groups=2,
         rules="expert_seqpar", mesh=(1, 2),
         shape=("granite_train_small", 256, 4, "train"),
         reduced_from="train_4k (B 256 x S 4096), 2 of 24 groups", steps=1,
         bytes="0.31 GB of weights, 0.31 of gradients, 0.31 of RMSProp "
               "state a rank"),
    dict(phase="spec_granite_decode", arch=GRANITE, groups=4, rules="expert",
         mesh=(1, 2), shape=("granite_decode_small", 64, 8, "decode"),
         reduced_from="decode_32k (B 128 x S 32768), 4 of 24 groups",
         steps=2, bytes="0.53 GB of weights a rank, a 4.2 MB cache"),
    dict(phase="spec_zamba_train", arch="zamba2-2.7b", groups=1,
         rules="seqpar", mesh=(1, 2),
         shape=("zamba_train_small", 256, 2, "train"),
         reduced_from="train_4k (B 256 x S 4096), 1 of 9 groups", steps=1,
         bytes="0.85 GB of weights, 0.85 of gradients, 0.85 of RMSProp "
               "state a rank"),
    dict(phase="spec_qwen32_train", arch="qwen3-32b", groups=1,
         rules="fsdp_seqpar", mesh=(2, 2),
         shape=("qwen32_train_small", 256, 2, "train"),
         reduced_from="train_4k (B 256 x S 4096), 1 of 64 groups", steps=1,
         bytes="2.0 GB of weights, 2.0 of gradients, 2.0 of RMSProp state "
               "a rank; 4.1 GB gathered over the data group a pass"),
    dict(phase="spec_qwen32_decode", arch="qwen3-32b", groups=1,
         rules="fsdp", mesh=(2, 2),
         shape=("qwen32_decode_small", 64, 4, "decode"),
         reduced_from="decode_32k (B 128 x S 32768), 1 of 64 groups",
         steps=1, bytes="2.0 GB of weights a rank; 4.1 GB gathered over "
                        "the data group a step"),
)
MH_ARGV = ["--mode", "serve", "--arch", XLSTM, "--shape", "decode_32k",
           "--steps", "10"]
# phase 3's K2 with its queries offset from the keys, (B, H, K, Sq, Sk,
# q_offset, hd): a rank's 256 of 512 queries at offset 256, then one rank's
# of phase 28b's context-parallel program (Qwen3-4B, S 256 over 2 ranks:
# rank 1's 128 queries at 128)
FLASH_OFFSET_SHAPES = [(1, 32, 8, 256, 512, 256, 128),
                       (2, 32, 8, 128, 256, 128, 128)]
# 28a: --mode rl-agent as two --coordinator processes sharing the card
# through gloo, against the same command's ranks spawned onto it (phase
# 8's Catch run, T 20, B 16 a rank)
MH_RL_STEPS = 4
MH_RL_ARGV = RESUME_ARGV + ["--steps", str(MH_RL_STEPS), "--mesh-data", "2"]
MH_RL_SHAPE = (20, 16)
# 28b: the context-parallel table's specs program at every published
# width of Qwen3-4B, float32, 2 of its 36 groups
CP_SPEC_RUN = dict(
    phase="spec_qwen4_cp_train", arch="qwen3-4b", groups=2,
    rules="cp_fsdp_seqpar", mesh=(1, 2),
    shape=("qwen4_cp_train_small", 256, 2, "train"),
    reduced_from="train_4k (B 256 x S 4096), 2 of 36 groups", steps=1,
    bytes="2.2 GB of weights (1.56 of them the embedding), half a rank, "
          "as much again in gradients and RMSProp state")
# 28c: the dry run on the card (one rank)
DRYRUN_ARGV = ["--arch", XLSTM, "--shape", "decode_32k", "--ranks", "1"]
# phase 29: the compiled decode step at full width against eager: the
# servers' sessions at phase_profile's prompt lengths and caps (Granite's
# as xLSTM's: prompts of up to 64 tokens in its server), slot 7 evicted;
# GRAPH_CHECK_STEPS steps (the first a warm eager step, the second the
# capture) and GRAPH_AFTER_STEPS after an in-place weight update, held
# bitwise; GRAPH_TIMED_STEPS steps a turn for the eager and graph times,
# GRAPH_PROFILED under the profiler
# Qwen3-4B's session at 9 of its 36 groups, Zamba2-2.7B's at 3 of 9 and
# Granite's at 12 of 24 (the last item; None: all), for the script's time
GRAPH_SESSIONS = (
    ("qwen3-4b", [256 + 32 * slot for slot in range(8)], 576, 9),
    ("zamba2-2.7b", [32 * (slot + 1) for slot in range(8)], 320, 3),
    (GRANITE, [8 * (slot + 1) for slot in range(8)], 128, 12),
    (XLSTM, [8 * (slot + 1) for slot in range(8)], 128, None))
GRAPH_CHECK_STEPS, GRAPH_AFTER_STEPS = 6, 2
GRAPH_TIMED_STEPS, GRAPH_PROFILED = 10, 5
# phase 30: the compiled rl-agent entries and admissions at full width
# against eager: learner steps on a linear anneal, unroll calls before a
# state_dict round trip, rounds of each admission (warm, capture, replay),
# calls a turn of the eager and graph times; the admissions' sessions: the
# servers' caps, two prefill buckets of 4 prompts each (Zamba2's Mamba2
# prefills exact lengths: one length a bucket)
GRAPH_LEARNER_STEPS, GRAPH_UNROLL_CALLS = 3, 4
GRAPH_ADMIT_ROUNDS, GRAPH_TIMED = 3, 5
# (arch, cap, the buckets' prompt lengths, groups): Qwen3-4B at 9 of 36
# groups, Zamba2-2.7B at 3 of 9, for the script's time
GRAPH_ADMITS = (
    ("qwen3-4b", 576, ([200, 220, 240, 256], [100, 110, 120, 128]), 9),
    ("zamba2-2.7b", 320, ([256] * 4, [128] * 4), 3),
)
# 29's Granite lm-rl generation at 8 of its 24 groups, for the script's
# time
GRAPH_SOURCE_GROUPS = 8
# the decode profiles (phases 10, 12, 23) at these depths of the three
# archs, for the script's time
PROFILE_GROUPS = {"qwen3-4b": 9, "zamba2-2.7b": 3, XLSTM: 2}
# phase 31: the compiled LM learner steps at full width against eager
# (GRAPH_LM_STEPS steps from the built state: warm, capture, replay), the
# trainers of phases 15, 16, 21 (lm-rl), 24 (lm) and 25 (the reduced VLM
# lm), the first two with their kept states in host memory; the host
# actors' policy at each bucket up to the 8 actors, GRAPH_POLICY_CALLS
# calls each; replay's value function, GRAPH_VALUE_CALLS calls and one
# after a weight update
GRAPH_LM_STEPS = 3
GRAPH_POLICY_CALLS, GRAPH_VALUE_CALLS = 3, 3
POLICY_BUCKETS = (1, 2, 4, 8)
# the LM trainers at full published width (phases 15, 16)
LM_RL_ARGV = ["--mode", "lm-rl", "--arch", "qwen3-4b", "--attn-impl",
              "kernel", "--vtrace-impl", "kernel", "--batch", "8", "--seq",
              "64", "--steps", "1"]
LM_ARGV = ["--mode", "lm", "--arch", "zamba2-2.7b", "--attn-impl", "kernel",
           "--ssd-impl", "kernel", "--batch", "4", "--seq", "512", "--steps",
           "1"]
# (argv, the state kept in host memory, groups (None: all)): Qwen3-4B at
# 9 of 36 groups, Zamba2-2.7B at 3 of 9, Granite at 8 of 24 and
# xLSTM-125M at 2 of 6, for the script's time (phase 33 holds the same
# graphs at up to 3.4B parameters)
GRAPH_LM_CASES = ((LM_RL_ARGV, True, 9), (LM_ARGV, True, 3),
                  (GLM_RL_ARGV, False, 8), (XLM_ARGV, False, 2),
                  (VLM_LM_ARGV, False, None))
# phase 32: the four families of configs/ no earlier phase runs, at every
# published width, depth cut only where their float32 weights would not
# leave the plain path room on the card: (arch, groups (None: all),
# batch, prompt length, 32b's requests). Gemma2-27B's 4,160 tokens and
# Mixtral-8x7B's 4,608 pass their 4,096-token window, so the rings wrap in
# the prefill; Mixtral's MoE routes groups of 512 tokens
# (moe.MOE_GROUP_SIZE), so its prompt is 9 of them. 32b serves each:
# each at the same depth through serve.run (no depth flag; MusicGen-Large
# at 24 of its 48 layers, for the script's time); then each one's compiled
# decode step against eager
FAMILY_MODELS = (("gemma2-27b", 4, 1, 4160, 12),
                 ("mixtral-8x7b", 4, 1, 4608, 12),
                 ("deepseek-coder-33b", 8, 4, 512, 12),
                 ("musicgen-large", 24, 4, 512, 24))
FAMILY_SERVE = ("--attn-impl", "kernel", "--prompt-len", "512",
                "--gen-tokens", "64", "--max-batch", "8")
FAMILY_SESSION = ([256 + 32 * slot for slot in range(8)], 576)
# phase 33: the same families trained at every published width through
# the entry point, 1 step each (bf16 activations on float32 weights,
# AdamW): (arch, lm-rl's groups, lm's groups, lm's batch, lm's sequence);
# lm-rl runs B 8 x T 64 (LM_RL_SHAPE) for each. Gemma2's and Mixtral's
# lm-rl runs keep their weights, gradients and both AdamW moments (16
# bytes a parameter) near Qwen3-4B's 64 GB (3,444,655,104 and
# 3,164,692,480 parameters at 2 of 23 and 2 of 32 groups); at 1 group
# Gemma2's generated episodes are so nearly deterministic that the first
# layer's q and k get no gradient but rounding (its float32 check's leaf
# bar, relative to the leaf, failed on it). The other runs are cut
# further for the script's time: Gemma2's and Mixtral's lm to 1 group,
# DeepSeek to 3 of 62, MusicGen to 12 of 48 layers. Gemma2's and
# Mixtral's lm sequences pass their 4,096-token window: 5,120 is the
# least length past it that both packages take, a multiple of the chunked
# loss's 512 and of the attn_chunk (1,024) that K2's backward recomputes
# in; Mixtral's 5,120 tokens route as 10 MoE groups of 512
FAMILY_TRAIN = (("gemma2-27b", 2, 1, 1, 5120),
                ("mixtral-8x7b", 2, 1, 1, 5120),
                ("deepseek-coder-33b", 3, 3, 4, 512),
                ("musicgen-large", 12, 12, 4, 512))
# phase 34: the repository's examples on the port (repro_torch.examples),
# each through its main as a user runs it, the reference's defaults but
# where named here: the V-trace ablation at one seed (700 steps, lag 40),
# the gridworld for 300 steps, lm_rl_100m at its default width (d 640, 16
# layers) with vocab 256 for 100 steps, serve_batched on the reduced
# Qwen3-4B (it adds --reduced) with the kernel attention; then
# EXAMPLE_GRAPH_STEPS steps of each graph the examples capture beyond
# phases 30 and 31 (the fused gridworld step, the user-written uncorrected
# step, one lm_rl_100m learner step) against eager from one state, and the
# lagged actors' refresh at a lag of EXAMPLE_LAG
ABLATION_ARGV = ["--seeds", "1"]
GRIDWORLD_ARGV = ["--steps", "300"]
LM_RL_100M_ARGV = ["--vocab", "256", "--steps", "100"]
SERVE_BATCHED_ARGV = ["--arch", "qwen3-4b", "--attn-impl", "kernel",
                      "--requests", "24"]
EXAMPLE_GRAPH_STEPS, EXAMPLE_LAG = 3, 3


def emit(phase, **fields):
    """One JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


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


def vtrace_inputs(t, b, seed, device="cuda"):
    """log_rhos, discounts, rewards, values (T, B) and bootstrap (B,),
    float32 on ``device``, drawn with numpy from ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(0, 1, (t, b)),
              (rng.random((t, b)) > 0.2) * 0.97,
              rng.normal(0, 1, (t, b)),
              rng.normal(0, 1, (t, b)),
              rng.normal(0, 1, (b,)))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


def vtrace_bound(t, b):
    """(bound_ms, bound_by) of the function the wrapper computes: four
    (T, B) inputs and the bootstrap read, vs and the advantages written,
    float32, VTRACE_FLOPS_PER_ELEM operations a cell. The reference's
    formula (``kernel_roofline("vtrace")``) counts its ``vtrace_scan``
    alone, whose deltas and discounts the reference computes outside the
    kernel and the port's kernel computes inside (the rows'
    ``roofline_ms``)."""
    return _bound((4 * t * b + b + 2 * t * b) * 4,
                  VTRACE_FLOPS_PER_ELEM * t * b, "float32")


def _roofline_ms(kernel, **dims):
    """(ms, bound) of one launch by the reference's formula on the card's
    peaks (``launch/roofline.py::kernel_roofline``)."""
    from repro_torch.launch.roofline import kernel_roofline
    rl = kernel_roofline(kernel, **dims)
    return rl["roofline_s"] * 1e3, rl["bound"]


def phase_kernel(ops, ref):
    import torch
    rows = {}
    for i, (t, b) in enumerate(VTRACE_SHAPES + REPLAY_VTRACE_SHAPES
                               + LM_RL_VTRACE_SHAPES):
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
            roof_ms, roof_by = _roofline_ms("vtrace", t=t, b=b)
            row = dict(T=t, B=b, max_abs_err=abs_err, max_rel_err=rel_err,
                       tol=VTRACE_TOL, ms=ms, graph_ms=dev_ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bound_share=bound_ms / dev_ms,
                       roofline_ms=roof_ms, roofline_bound=roof_by,
                       host_loop_us=host_loop_us(
                           lambda: ops.vtrace_from_importance_weights_kernel(
                               *args)),
                       library_ms=None,
                       library_note="no single PyTorch call computes the "
                                    "V-trace recurrence")
            rows[(t, b)] = row
            emit("kernel", name="vtrace", **row)
    return rows


def _bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the card's peak rate for the inputs' type,
    from the port's roofline (``launch/roofline.py::bound``)."""
    from repro_torch.launch.roofline import bound
    b = bound(flops, nbytes, dtype)
    return b["roofline_s"] * 1e3, ("bytes" if b["bound"] == "memory"
                                   else "operations")


def _compare(got, want_f32, dtype):
    """Max abs error of the kernel against its plain version, checked:
    float32 within ATTN_TOL; bf16 against the plain version run in float32
    on the same bf16 inputs and then rounded, within one bf16 ulp
    (BF16_RTOL relative) or ATTN_TOL absolute. The check rounds."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite kernel output")
    want = want_f32.to(dtype).float()
    got = got.float()
    err = (got - want).abs().max().item()
    rtol = ATTN_TOL if dtype == torch.float32 else BF16_RTOL
    if not torch.allclose(got, want, rtol=rtol, atol=ATTN_TOL):
        raise AssertionError(f"max abs err {err:.3e} above rtol {rtol:.2e}, "
                             f"atol {ATTN_TOL:.0e}")
    return err


def host_loop_us(fn, calls=1000):
    """Microseconds per call of ``calls`` back-to-back calls ended by one
    synchronize, on the host clock: the wrapper's host time per call
    wherever it exceeds the device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _time_row(kernel, plain, library, nbytes, flops, dtype, graph_launches):
    """Events and graph times of the kernel's wrapper and of the library
    call (SDPA), the plain version's events time, the bound and the
    kernel's share of it, and the wrapper's host time per call."""
    reps = 20
    row = dict(ms=event_ms(kernel, reps),
               graph_ms=graph_ms(kernel, graph_launches),
               plain_ms=event_ms(plain, 5),
               library_ms=None if library is None else event_ms(library,
                                                                reps),
               library_graph_ms=None if library is None
               else graph_ms(library, graph_launches))
    # a call of a millisecond or more is device-bound: fewer calls tell
    # the same (1,000 calls of a 4,608-token row took 6 s on an NVIDIA
    # H100 80GB HBM3 at 700 W)
    row["host_loop_us"] = host_loop_us(
        kernel, 1000 if row["graph_ms"] < 1 else 50)
    row["bound_ms"], row["bound_by"] = _bound(nbytes, flops, dtype)
    row["bound_share"] = row["bound_ms"] / row["graph_ms"]
    return row


def phase_flash(ops, ref):
    """Flash attention against its plain version at every FLASH_SHAPES
    entry in bf16 and float32. Returns {(shape, dtype name): row}."""
    import torch
    import torch.nn.functional as F
    rows = {}
    for i, shape in enumerate(FLASH_SHAPES):
        b, h, kh, s, hd, window, cap = shape
        gen = torch.Generator(device="cuda").manual_seed(2000 + i)
        q32 = torch.randn((b, h, s, hd), generator=gen, device="cuda")
        k32 = torch.randn((b, kh, s, hd), generator=gen, device="cuda")
        v32 = torch.randn((b, kh, s, hd), generator=gen, device="cuda")
        kw = dict(window=window, softcap=cap)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.ref_flash_attention(q.float(), k.float(), v.float(),
                                           **kw)
            torch.cuda.synchronize()
            err = _compare(got, want, dtype)
            del got, want
            pairs = sum(min(i + 1, window or s) for i in range(s))
            flops = 4 * hd * h * b * pairs
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
            library = None
            if not window and not cap:
                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
            elif not cap:
                pos = torch.arange(s, device="cuda")
                back = pos[:, None] - pos[None, :]
                mask = (back >= 0) & (back < window)

                def library():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
            row = _time_row(
                lambda: ops.flash_attention(q, k, v, **kw),
                lambda: ref.ref_flash_attention(q, k, v, **kw), library,
                nbytes, flops, dtype, 10 if s > 1000 else 50)
            row["roofline_ms"], row["roofline_bound"] = _roofline_ms(
                "flash_attention", dtype_bytes=q.element_size(),
                dtype=str(dtype).split(".")[1], b=b, h=h, kh=kh, s=s, hd=hd,
                window=window)
            row.update(max_abs_err=err, dtype=str(dtype).split(".")[1],
                       shape=[b, h, kh, s, hd], window=window, softcap=cap)
            rows[(shape, row["dtype"])] = row
            emit("kernel", name="flash_attention", **row)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def _decode_inputs(shape, seed):
    """q (B,H,hd), the cache k, v in the model's (B,cap,K,hd) layout,
    slot_pos and pos as the serving path builds them."""
    import torch
    b, h, kh, cap, hd, pos_kind, window, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, hd), generator=gen, device="cuda")
    k = torch.randn((b, cap, kh, hd), generator=gen, device="cuda")
    v = torch.randn((b, cap, kh, hd), generator=gen, device="cuda")
    idx = torch.arange(cap, dtype=torch.int32, device="cuda")
    if pos_kind == "scalar":
        return q, k, v, idx, cap - 1
    lo, hi = (cap, 4 * cap) if pos_kind == "ring" else (cap // 2, cap)
    pos = torch.randint(lo, hi, (b,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if pos_kind == "ring":
        slot = pos[:, None] - torch.remainder(pos[:, None] - idx, cap)
    else:
        slot = idx.expand(b, cap)
    return q, k, v, slot, pos


def phase_decode(ops, ref):
    """Decode attention against its plain version at every DECODE_SHAPES
    entry in bf16 and float32. Returns {(shape, dtype name): row}."""
    import torch
    import torch.nn.functional as F
    rows = {}
    for i, shape in enumerate(DECODE_SHAPES):
        b, h, kh, cap, hd, pos_kind, window, cap_soft = shape
        q32, k32, v32, slot, pos = _decode_inputs(shape, 3000 + i)
        kw = dict(window=window, softcap=cap_soft)
        pos_t = torch.as_tensor(pos, device="cuda").reshape(-1).expand(b)
        valid = (slot >= 0) & (slot <= pos_t[:, None])
        if window:
            valid &= pos_t[:, None] - slot < window
        n_valid = int(valid.expand(b, cap).sum())
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)   # views
            got = ops.decode_attention(q, kt, vt, slot, pos, **kw)
            want = ref.ref_decode_attention(q.float(), kt.float(),
                                            vt.float(), slot, pos, **kw)
            torch.cuda.synchronize()
            err = _compare(got, want, dtype)
            # bytes the function needs: q and o, the K and V rows of valid
            # slots only, slot_pos and pos
            esize = q.element_size()
            nbytes = (2 * q.numel() + 2 * n_valid * kh * hd) * esize \
                + 4 * (slot.numel() + b)
            flops = 4 * hd * (h // kh) * kh * n_valid
            library = None
            if not cap_soft:
                mask = valid.expand(b, cap)[:, None, None, :]
                q4 = q[:, :, None]

                def library():
                    return F.scaled_dot_product_attention(
                        q4, kt, vt, attn_mask=mask, enable_gqa=True)
            row = _time_row(
                lambda: ops.decode_attention(q, kt, vt, slot, pos, **kw),
                lambda: ref.ref_decode_attention(q, kt, vt, slot, pos, **kw),
                library, nbytes, flops, dtype, 50)
            row["roofline_ms"], row["roofline_bound"] = _roofline_ms(
                "decode_attention", dtype_bytes=esize,
                dtype=str(dtype).split(".")[1], b=b, h=h, kh=kh, s=cap,
                hd=hd)
            row.update(max_abs_err=err, dtype=str(dtype).split(".")[1],
                       shape=[b, h, kh, cap, hd], pos=pos_kind,
                       window=window, softcap=cap_soft, valid_slots=n_valid,
                       splits=ops.last_decode_split()[0])
            rows[(shape, row["dtype"])] = row
            emit("kernel", name="decode_attention", **row)
    return rows


def _ssd_inputs(shape, seed):
    """c, b, x, da, h_prev on the card for one SSD_SHAPES entry, in the
    model's layout when heads > 1, else the reference's."""
    import torch
    slices, length, n, p, heads, decay = shape
    rows = slices // heads
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*dims):
        return torch.randn(dims, generator=gen, device="cuda")

    c, b = rand(rows, length, n), rand(rows, length, n)
    if heads > 1:
        x, h = rand(rows, length, heads, p), rand(rows, heads, p, n)
        da = -decay * torch.rand((rows, length, heads), generator=gen,
                                 device="cuda")
    else:
        x, h = rand(rows, length, p), rand(rows, p, n)
        da = -decay * torch.rand((rows, length, 1), generator=gen,
                                 device="cuda")
    return c, b, x, da, h


def _ssd_work(shape):
    """(bytes, flops) of one SSD chunk call: the lower triangle's
    multiply-adds (C B^T and the weighted sum of X, L(L+1)/2 (2N + 2P) per
    slice) and the two L x N x P products (C h^T, X^T B), against every
    input read once (B/C once per group) and both outputs written once."""
    slices, length, n, p, heads, _ = shape
    flops = slices * (length * (length + 1) // 2 * (2 * n + 2 * p)
                      + 4 * length * n * p)
    groups = slices // heads
    nbytes = 4 * (2 * groups * length * n + 2 * slices * length * p
                  + slices * length + 2 * slices * p * n)
    return nbytes, flops


def ssd_bound(shape):
    """(bound_ms, bound_by) of one SSD chunk call in float32 (_ssd_work)."""
    import torch
    return _bound(*_ssd_work(shape), torch.float32)


def ssd_tc_bound(shape):
    """(bound_ms, bound_by) of the same work on the tensor cores as the
    kernel runs it: every product three TF32 MMAs (3xTF32)."""
    nbytes, flops = _ssd_work(shape)
    return _bound(nbytes, 3 * flops, "tf32")


def phase_ssd(ops, ref):
    """The SSD chunk kernel against its plain version at every SSD_SHAPES
    entry: y and h_new within the reference's 3e-5, widened by four times
    the float32 plain version's own error against the same plain version
    in float64 (kernels.ref.ssd_tolerance says why). Returns {shape: row}."""
    import torch
    rows = {}
    for i, shape in enumerate(SSD_SHAPES):
        heads = shape[4]
        args = _ssd_inputs(shape, 4000 + i)
        plain = ref.ref_ssd_chunk_heads if heads > 1 else ref.ref_ssd_chunk
        got = ops.ssd_chunk(*args)
        want = plain(*args)
        exact = plain(*(a.double() for a in args))
        torch.cuda.synchronize()
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"ssd_chunk {shape}: non-finite output")
        err = {}
        for name, g, w, e in zip(("y", "h_new"), got, want, exact):
            tol = ref.ssd_tolerance(w, e)
            err[name] = dict(max_abs_err=(g - w).abs().max().item(),
                             kernel_vs_float64=(g - e).abs().max().item(),
                             plain_vs_float64=(w - e).abs().max().item(),
                             atol=tol["atol"], rtol=tol["rtol"])
            if not torch.allclose(g, w, **tol):
                raise AssertionError(f"ssd_chunk {shape}: {name} {err}")
        del got, want, exact
        row = dict(ms=event_ms(lambda: ops.ssd_chunk(*args), 20),
                   graph_ms=graph_ms(lambda: ops.ssd_chunk(*args), 20),
                   plain_ms=event_ms(lambda: plain(*args), 5),
                   library_ms=None,
                   library_note="no single PyTorch call computes the chunk",
                   host_loop_us=host_loop_us(lambda: ops.ssd_chunk(*args)))
        row["bound_ms"], row["bound_by"] = ssd_bound(shape)
        row["bound_share"] = row["bound_ms"] / row["graph_ms"]
        row["tc_bound_ms"], row["tc_bound_by"] = ssd_tc_bound(shape)
        row["roofline_ms"], row["roofline_bound"] = _roofline_ms(
            "ssd_chunk", dtype_bytes=4, bh=shape[0], l=shape[1], n=shape[2],
            p=shape[3])
        row.update(shape=list(shape[:4]), heads=heads, decay=shape[5],
                   layout="model" if heads > 1 else "reference",
                   max_abs_err=max(e["max_abs_err"] for e in err.values()),
                   errors=err)
        rows[shape] = row
        emit("kernel", name="ssd_chunk", **row)
        del args
        torch.cuda.empty_cache()
    return rows


def kernel_layers(cfg):
    """(self-attention layers, Mamba2 layers) a token passes through: the
    shared block counts once per group. The port's causal kinds are the
    ones that run the attention kernels (xattn runs neither)."""
    from repro_torch.models.attention import CAUSAL_KINDS

    def count(kinds):
        return sum(m in kinds for m, _ in cfg.block_pattern) * cfg.num_groups
    shared = cfg.num_groups if cfg.shared_attn_every else 0
    return count(CAUSAL_KINDS) + shared, count(("mamba",))


@contextlib.contextmanager
def recorded_routes(log):
    """Append every MoE routing decision made inside the block to the
    list ``log`` as (expert indices, top-k margin): the gap between the
    k-th and the (k+1)-th router probability of each token, which says
    how near the token came to another expert."""
    import torch

    from repro_torch.models import moe
    route = moe.route

    def recording(probs, k):
        values, idx = route(probs, k)
        ranked, _ = torch.sort(probs, dim=-1, descending=True, stable=True)
        log.append((idx, ranked[..., k - 1] - ranked[..., k]))
        return values, idx

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = route


@contextlib.contextmanager
def pinned_routes(recorded, flips):
    """Route every MoE call inside the block as the calls ``recorded``
    (``recorded_routes``' list, in the same order) did: the recorded
    experts, weighted by this call's own probabilities of them. For the
    tokens whose own top-k would be another set of experts, append the
    recorded top-k margins to the list ``flips``."""
    import torch

    from repro_torch.models import moe
    route, calls = moe.route, iter(recorded)

    def pinned(probs, k):
        idx, margin = next(calls)
        _, own = route(probs, k)
        moved = (own.sort(-1).values != idx.sort(-1).values).any(-1)
        if bool(moved.any()):
            flips.append(margin[moved])
        return torch.gather(probs, -1, idx), idx

    moe.route = pinned
    try:
        yield flips
    finally:
        moe.route = route


def routing_flips(plain, kernel, layers, prompt_len):
    """Tokens the two paths sent to different sets of experts, call by
    call (the prefill's ``layers`` calls, then each decode step's), and
    the count of tokens whose experts agree but come in another order.
    The order within a token's top-k moves no token-slot in the capacity
    count (a token takes each expert once) and only the order of its k
    terms in the combine."""
    flips, reordered = [], 0
    for call, ((ia, ma), (ib, mb)) in enumerate(zip(plain, kernel)):
        sa, sb = ia.sort(-1).values, ib.sort(-1).values
        reordered += int(((ia != ib).any(-1) & (sa == sb).all(-1)).sum())
        for pos in (sa != sb).any(-1).nonzero().tolist():
            where = ("prefill" if call < layers
                     else f"decode step {call // layers - 1}")
            flips.append(dict(
                layer=call % layers, where=where,
                token=pos[-1] + pos[0] * ia.shape[-2],
                prompt_len=prompt_len,
                experts_plain=ia[tuple(pos)].tolist(),
                experts_kernel=ib[tuple(pos)].tolist(),
                margin_plain=float(ma[tuple(pos)]),
                margin_kernel=float(mb[tuple(pos)])))
    return flips, reordered


def vision_stub(cfg, batch, dtype):
    """A VLM's patch embeddings (B, vision_seq, d) drawn on the card from
    a generator seeded with 0; None for a text-only config."""
    import torch
    if not cfg.vision_seq:
        return None
    gen = torch.Generator(device="cuda").manual_seed(0)
    return torch.randn((batch, cfg.vision_seq, cfg.d_model), generator=gen,
                       device="cuda").to(dtype)


def phase_model(ops, arch, prompt_len, phase="model", groups=None,
                batch=4):
    """``arch`` at full width in float32 with weights from seed 0 (and
    ``groups`` of its groups, where given): ``batch`` prompts of
    ``prompt_len`` tokens and 16 teacher-forced decode steps through the
    kernel path
    (every kernel of the arch) and the plain path; logits must agree
    within MODEL_TOL, and the kernel path must launch each kernel once
    per layer that runs it and call. A VLM's prefill reads the seeded
    vision stub. An MoE arch must
    also route every token of both paths to the same set of experts: the
    tokens routed differently are counted and printed with their top-k
    margins (the gap between the k-th and the (k+1)-th probability)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              num_groups=groups or get_config(arch).num_groups)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    p, n, b = prompt_len, 16, batch
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p + n))).cuda()
    vision = vision_stub(cfg, b, torch.float32)
    logits, launches, seconds, routes = {}, {}, {}, {}
    with torch.no_grad():
        for impl in ("xla", "kernel"):
            icfg = dataclasses.replace(cfg, attn_impl=impl, ssd_impl=impl)
            ops.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorded_routes([]) as routes[impl]:
                h, _, cache = model_lib.prefill(
                    params, tokens[:, :p], cfg=icfg, vision=vision,
                    cache_seq_len=p + n)
                out = [model_lib.logits_from_hidden(params, icfg,
                                                    h[:, -1:])]
                del h
                for t in range(p, p + n):
                    pos = torch.full((b,), t, dtype=torch.int32,
                                     device="cuda")
                    lg, _, cache = model_lib.serve_step(
                        params, tokens[:, t:t + 1], cache, pos, cfg=icfg)
                    out.append(lg)
            torch.cuda.synchronize()
            seconds[impl] = time.perf_counter() - t0
            logits[impl] = torch.cat(out, dim=1)
            launches[impl] = ops.stats()
            del cache
    diff = (logits["kernel"] - logits["xla"]).abs().max().item()
    finite = bool(torch.isfinite(logits["kernel"]).all())
    attn, mamba = kernel_layers(cfg)
    want = {"vtrace": 0, "flash_attention": attn,
            "decode_attention": attn * n,
            "ssd_chunk": mamba * -(-p // min(p, cfg.ssm_chunk))}
    moe_fields, flips = {}, []
    if cfg.num_experts:
        flips, reordered = routing_flips(routes["xla"], routes["kernel"],
                                         cfg.num_layers, p)
        margins = torch.cat([m.flatten() for _, m in routes["xla"]])
        moe_fields = dict(
            routing_calls=len(routes["xla"]),
            routed_tokens=int(sum(i.shape[0] * i.shape[1]
                                  for i, _ in routes["xla"])),
            routing_flips=len(flips), flips=flips[:20],
            reordered_tokens=reordered,
            min_topk_margin=margins.min().item(),
            median_topk_margin=margins.median().item())
    emit(phase, arch=cfg.name, dtype=cfg.dtype, num_groups=cfg.num_groups,
         published_groups=get_config(arch).num_groups,
         vision_seq=cfg.vision_seq,
         params=sum(x.numel() for x in params.parameters()),
         init_seconds=init_s, prompts=b, prompt_len=p,
         teacher_forced_steps=n, logits_shape=list(logits["kernel"].shape),
         max_abs_logit_diff=diff, tol=MODEL_TOL, seconds=seconds,
         kernel_launches=launches["kernel"],
         peak_mem_bytes=torch.cuda.max_memory_allocated(), **moe_fields)
    del params, logits, routes, vision
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("full-width kernel-path logits not finite")
    if flips:
        raise AssertionError(f"{len(flips)} tokens routed to other experts "
                             f"by the kernel path; first: {flips[0]}")
    if not diff <= MODEL_TOL:
        raise AssertionError(f"full-width kernel-path logits differ from the "
                             f"plain path by {diff:.3e} > {MODEL_TOL}")
    if launches["kernel"] != want or any(launches["xla"].values()):
        raise AssertionError(f"model launches {launches}, kernel path "
                             f"should be {want}")


def phase_serve(ops, argv, phase="serve", groups=None):
    """A serving main path at full width through ``serve.main(argv)``
    (with ``groups``, through ``serve.run`` on the config cut to that
    many groups): every request served and echoed; per admission one
    flash-attention launch per attention layer and one SSD chunk launch
    per Mamba2 layer (every prompt is at most one chunk), per decode step
    one decode-attention launch per attention layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ImplContext
    from repro_torch.launch import serve

    from repro_torch.core import generate as gen_lib

    def graph_counts():
        fns = list(gen_lib._FNS_CACHE.values())
        return (sum(f.admissions.captures for f in fns),
                sum(f.admissions.capture_s for f in fns),
                sum(f.captures for f in fns), sum(f.steps.capture_s
                                                  for f in fns))

    cfg = get_config(_arg(argv, "--arch"))
    cfg = dataclasses.replace(cfg, num_groups=groups or cfg.num_groups)
    attn, mamba = kernel_layers(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    ops.reset_stats()
    counts0 = graph_counts()
    with contextlib.redirect_stdout(buf):
        if groups:
            args = serve._parser().parse_args(argv)
            summary = serve.run(args, ImplContext.from_args(args).apply(cfg),
                                torch.device("cuda"))
        else:
            summary = serve.main(argv)
    launches = ops.stats()
    peak = torch.cuda.max_memory_allocated()
    counts = [b - a for a, b in zip(counts0, graph_counts())]
    for line in buf.getvalue().strip().splitlines():
        print("  " + line, flush=True)
    emit(phase, argv=argv, num_groups=cfg.num_groups, launches=launches,
         peak_mem_bytes=peak,
         admission_captures=counts[0], admission_capture_s=counts[1],
         step_captures=counts[2], step_capture_s=counts[3], **summary)
    if summary["served"] != summary["requests"] \
            or not summary["prompt_echo_ok"]:
        raise AssertionError(f"served {summary['served']} of "
                             f"{summary['requests']}, echo "
                             f"{summary['prompt_echo_ok']}")
    want = {"vtrace": 0, "flash_attention": attn * summary["admissions"],
            "ssd_chunk": mamba * summary["admissions"],
            "decode_attention": attn * summary["steps"]}
    if launches != want or not summary["admissions"] \
            or not summary["steps"]:
        raise AssertionError(
            f"serve launches {launches} for {summary['admissions']} "
            f"admissions and {summary['steps']} steps, want {want}")
    return launches


def _profiled(fn, reps):
    """Host ms per call of ``fn`` under torch.profiler, the device's busy
    ms per call (None when the profiler records no device time), and the
    device kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return host_ms, busy_ms or None, dict(
        launches_per_call=sum(e.count for e in kernels) / reps,
        top_kernels=[{"name": e.key[:80],
                      "ms_per_call": e.self_device_time_total / reps / 1e3,
                      "calls_per_call": e.count / reps} for e in top])


def phase_profile(arch, prompt_lens, cap, groups=None):
    """Where one full-width serving decode step (``groups`` of the arch's
    groups, where given) spends its time: 8 slots
    admitted with ``prompt_lens`` into ``cap``-slot caches, then 5 decode
    steps timed on the host clock, and 5 more under torch.profiler for the
    device's busy time by kernel; then one admission of the longest prompt
    into a freed slot, under the profiler. Device numbers are reported as
    not measured when the profiler records no device time."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.generate import DecodeSession
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(
        get_config(arch), attn_impl="kernel", ssd_impl="kernel",
        num_groups=groups or get_config(arch).num_groups)
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = DecodeSession(params, cfg, max_batch=8, max_len=cap)
    rng = np.random.default_rng(1)
    for slot, n in enumerate(prompt_lens):
        sess.prefill_into(slot, rng.integers(0, cfg.vocab_size, n),
                          seed=slot)
    for _ in range(3):
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        sess.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    profiled_ms, busy_ms, step_kernels = _profiled(sess.step, 5)
    sess.evict(7)
    prompt = rng.integers(0, cfg.vocab_size, max(prompt_lens))
    admit_ms, admit_busy_ms, admit_kernels = _profiled(
        lambda: sess.prefill_into(7, prompt, seed=7), 1)

    def measured(x):
        return x if x is not None else "not measured"

    emit("profile", arch=cfg.name, num_groups=cfg.num_groups,
         dtype=cfg.dtype, slots=8, cap=cap,
         step_ms=step_ms, profiled_step_ms=profiled_ms,
         device_busy_ms=measured(busy_ms),
         device_idle_share=measured(busy_ms and 1 - busy_ms / profiled_ms),
         **step_kernels,
         admission={"prompt_len": max(prompt_lens),
                    "profiled_ms": admit_ms,
                    "device_busy_ms": measured(admit_busy_ms),
                    **admit_kernels})
    del sess, params
    torch.cuda.empty_cache()


def synthetic_batch(gen, t, b):
    """A full-width rollout batch (84x84x4 obs, 18 actions) drawn on the
    card from ``gen``."""
    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE
    return {
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


def phase_learner(ops):
    import copy

    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE, TRAIN
    from repro_torch.core import compiled
    from repro_torch.core import learner as learner_lib
    from repro_torch.models.convnet import impala_deep
    from repro_torch.optim import make_optimizer

    t, b = TRAIN.unroll_length, TRAIN.batch_size
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(0),
                            t, b)
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

    # the step as train.build_rl_agent wraps it: its first call eager, the
    # second captures its CUDA graph, the third replays it
    step_fn = compiled.TrainStep(
        learner_lib.make_train_step(opt, TRAIN, vtrace_impl="kernel"), opt)
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
         vtrace_launches=launches, peak_mem_bytes=peak,
         captures=step_fn.captures)
    if step_fn.captures != 1:
        raise AssertionError(f"learner: {step_fn.captures} captures, not 1")


class SyntheticSource:
    """A seeded full-width rollout source: each ``next_batch`` draws a new
    batch on the card (``synthetic_batch``); nothing stays in flight."""

    def __init__(self, t, b, seed):
        import torch
        self._gen = torch.Generator(device="cuda").manual_seed(seed)
        self.t, self.b = t, b
        self.frames_per_batch = t * b

    def start(self, params):
        pass

    def next_batch(self, params):
        return synthetic_batch(self._gen, self.t, self.b)

    def stop(self):
        pass


def _nbytes(batch, cols, total):
    """Bytes of ``cols`` of the ``total`` columns of a mixed batch."""
    return sum(v.numel() * v.element_size() * cols // total
               for k, v in batch.items() if k != "is_replay")


def phase_replay_learner(ops):
    """The full-width learner on replay's mixed batches: a ReplaySource
    (elite, ratio 1.0, the agent's baseline as value_fn) over a seeded
    synthetic source at the IMPALA deep agent's width (84x84x4, T 80,
    B 32 fresh + 32 replayed), REPLAY_LEARNER_STEPS learner steps with the
    CLEAR costs on, priorities fed back. Gates: finite losses, one K1
    launch a step, the first loss against the plain-loop V-trace path.
    Returns K1's launches."""
    import copy

    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE, TRAIN
    from repro_torch.core import compiled
    from repro_torch.core import learner as learner_lib
    from repro_torch.core.replay import EliteReplay
    from repro_torch.core.sources import ReplaySource
    from repro_torch.models.convnet import impala_deep
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(TRAIN, clear_policy_cost=0.01,
                              clear_value_cost=0.005)
    t, b = cfg.unroll_length, cfg.batch_size
    agent = impala_deep(OBS_SHAPE, NUM_ACTIONS,
                        generator=torch.Generator().manual_seed(0)).cuda()

    def value_fn(params, obs):
        return params(obs).baseline

    source = ReplaySource(SyntheticSource(t, b, seed=0),
                          EliteReplay(REPLAY_LEARNER_CAPACITY),
                          replay_ratio=1.0, seed=0, value_fn=value_fn)
    opt = make_optimizer(cfg)
    step_fn = compiled.TrainStep(
        learner_lib.make_train_step(opt, cfg, vtrace_impl="kernel"), opt)
    opt_state = opt.init(list(agent.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, next_ms, drain_ms, learner_ms, splits = [], [], [], [], []
    scan_loss = None
    ops.reset_stats()
    for step in range(REPLAY_LEARNER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = source.next_batch(agent)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        next_ms.append((t1 - t0) * 1e3)
        drain_ms.append((t2 - t1) * 1e3)
        splits.append(dict(source.split_ms))
        if step == 0:
            # the plain-loop V-trace path from the same weights on the
            # same first mixed batch (it launches no kernel)
            scan_agent = copy.deepcopy(agent)
            _, _, m = learner_lib.make_train_step(
                opt, cfg, vtrace_impl="scan")(
                scan_agent, opt.init(list(scan_agent.parameters())), 0,
                batch)
            scan_loss = float(m["loss"])
            del scan_agent, m
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent, opt_state, metrics = step_fn(agent, opt_state, step, batch)
        torch.cuda.synchronize()
        learner_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        source.on_learner_metrics(step, metrics)
    launches = ops.stats()["vtrace"]
    chunks = ops.last_vtrace_chunks()
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"replay learner loss not finite: {losses}")
    if launches != REPLAY_LEARNER_STEPS:
        raise AssertionError(f"replay learner made {launches} vtrace "
                             f"launches, not {REPLAY_LEARNER_STEPS}")
    if not math.isclose(losses[0], scan_loss, rel_tol=1e-4, abs_tol=1e-4):
        raise AssertionError(f"replay kernel-path loss {losses[0]} != "
                             f"scan-path loss {scan_loss}")
    if tuple(batch["is_replay"].shape) != (2 * b,):
        raise AssertionError(f"is_replay {tuple(batch['is_replay'].shape)}")
    obs = batch["obs"][:-1, :b]
    value_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            value_fn(agent, obs)
        torch.cuda.synchronize()
        value_ms.append((time.perf_counter() - t0) * 1e3)
    fresh_bytes = _nbytes(batch, b, 2 * b)
    stats = source.stats()
    buffer_bytes = sum(a.nbytes for a in source.buffer._arrays.values())
    source.stop()
    steady = slice(1, None)      # the first call also pins its host pages
    emit("replay_learner", agent="impala_deep", obs=list(OBS_SHAPE),
         actions=NUM_ACTIONS, T=t, B_fresh=b, B_replayed=b,
         buffer="elite", capacity=REPLAY_LEARNER_CAPACITY,
         buffer_host_bytes=buffer_bytes,
         clear_costs=[cfg.clear_policy_cost, cfg.clear_value_cost],
         losses=losses, scan_loss=scan_loss, vtrace_launches=launches,
         vtrace_chunks=list(chunks),
         next_batch_ms=statistics.median(next_ms[steady]),
         first_next_batch_ms=next_ms[0],
         split_ms={k: statistics.median(s[k] for s in splits[steady])
                   for k in splits[-1]},
         drain_ms=statistics.median(drain_ms[steady]),
         value_fn_ms=statistics.median(value_ms[1:]),
         learner_ms=statistics.median(learner_ms[steady]),
         peak_mem_bytes=peak,
         bytes_per_step={"to_host": fresh_bytes, "to_device": fresh_bytes,
                         "host_copies": 3 * fresh_bytes},
         replay_stats=stats)
    del agent, opt_state, batch, source
    torch.cuda.empty_cache()
    return launches


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
    run_trainer.lines = lines
    return runtime, seconds, lines[-1] if lines else ""


def _compiled_line():
    """The last trainer run's ``compiled:`` line."""
    return next(line for line in run_trainer.lines
                if line.startswith("compiled:"))


def split_ms(runtime, reps=5):
    """Synchronised host-clock medians of the two halves of a trainer step
    after its run: one rollout batch from the source (restarted by its
    first next_batch, stopped at the end), one learner step. Returns them
    and the last batch."""
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
    return {"unroll_ms": unroll_ms, "learner_ms": learner_ms}, batch


def replay_overlap(runtime, reps=4):
    """Whether replay's host copy of the fresh batch waited for the unroll
    that the double-buffered DeviceSource leaves in flight. After a
    synchronize, ``next_batch`` is timed on the host, and on the card from
    an event just before the call to two events: the end of the host copy
    (``ReplaySource.copy_event``, on its side stream) and one recorded
    behind the unroll in flight (on the main stream, as soon as the inner
    source returns). A copy that ended first did not wait; one that ended
    later may only have been queued after the card had caught up with the
    host (``unroll_lag_ms``, the unroll's device work left when the host
    had queued all of it, tells which). The first call after the source's
    restart dispatches two unrolls; it is left out of the medians."""
    import torch
    src = runtime.source
    inner_next = src.inner.next_batch
    marks = {}

    def marked(params):
        out = inner_next(params)
        marks["unroll"] = torch.cuda.Event(enable_timing=True)
        marks["unroll"].record()
        return out

    src.inner.next_batch = marked
    rows = []
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            src.next_batch(runtime.params)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            rows.append(dict(
                host_ms=host_ms,
                copy_done_ms=start.elapsed_time(src.copy_event),
                unroll_done_ms=start.elapsed_time(marks["unroll"]),
                **{f"{k}_ms": v for k, v in src.split_ms.items()}))
    finally:
        del src.inner.next_batch
        src.stop()
    steady = rows[1:]
    return {"next_batch_host_ms": statistics.median(r["host_ms"]
                                                     for r in steady),
            "copy_done_ms": statistics.median(r["copy_done_ms"]
                                              for r in steady),
            "unroll_done_ms": statistics.median(r["unroll_done_ms"]
                                                for r in steady),
            # device work of the unroll left when the host had queued it
            # (the start event ran on an idle card at the host's t0)
            "unroll_lag_ms": statistics.median(
                r["unroll_done_ms"] - r["inner_ms"] for r in steady),
            "copy_ended_before_unroll": [
                r["copy_done_ms"] < r["unroll_done_ms"] for r in steady],
            "split_ms": {k: statistics.median(r[f"{k}_ms"] for r in steady)
                         for k in src.split_ms}}


def phase_replay_trainer(ops, base):
    """repro_torch.launch.train.main with --replay elite on the phase-5
    run (the device actors, double-buffered), then the overlap check;
    ``base`` is phase 5's record, set beside it. Returns K1's launches."""
    ops.reset_stats()
    runtime, seconds, last = run_trainer(TRAINER_ARGV + ["--replay",
                                                         "elite"])
    launches = ops.stats()
    chunks = ops.last_vtrace_chunks()
    if launches["vtrace"] < 20:
        raise AssertionError(f"replay trainer made {launches} vtrace "
                             "launches, fewer than its 20 steps")
    left = _host_threads()
    if left:
        raise AssertionError(f"replay trainer left threads alive: {left}")
    loss = float(runtime.metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"replay trainer loss not finite: {loss}")
    emit("replay_trainer", env="gridworld", agent="deep", replay="elite",
         T=TRAINER_SHAPE[0], B_fresh=TRAINER_SHAPE[1],
         B_learner=2 * TRAINER_SHAPE[1], steps=20, seconds=seconds,
         ms_per_step=seconds / 20 * 1e3, launches=launches,
         vtrace_chunks=list(chunks), fps_line=last, loss=loss,
         overlap=replay_overlap(runtime),
         **split_ms(runtime)[0],
         without_replay={k: base[k] for k in ("ms_per_step", "fps_line",
                                              "unroll_ms", "learner_ms")})
    return launches["vtrace"]


def phase_replay_host(ops, base):
    """--actors host --replay uniform through the entry point (the fresh
    batch crosses to the card and back); ``base`` is phase 7's record.
    Returns K1's launches."""
    ops.reset_stats()
    runtime, seconds, last = run_trainer(HOST_ARGV + ["--replay",
                                                      "uniform"])
    launches = ops.stats()
    left = _host_threads()
    if left:
        raise AssertionError(f"host replay left threads alive: {left}")
    if launches["vtrace"] < HOST_STEPS:
        raise AssertionError(f"host replay made {launches} vtrace "
                             f"launches, fewer than its {HOST_STEPS} steps")
    loss = float(runtime.metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"host replay loss not finite: {loss}")
    emit("replay_host", env="gridworld", agent="deep", replay="uniform",
         actors=8, T=TRAINER_SHAPE[0], B_fresh=TRAINER_SHAPE[1],
         steps=HOST_STEPS, seconds=seconds,
         ms_per_step=seconds / HOST_STEPS * 1e3, launches=launches,
         fps_line=last, loss=loss, split_ms=runtime.source.split_ms,
         threads_left=left,
         without_replay={k: base[k] for k in ("ms_per_step", "fps_line")})
    return launches["vtrace"]


def _host_threads():
    import threading
    return sorted(t.name for t in threading.enumerate() if t.is_alive()
                  and (t.name == "inference" or t.name.startswith("actor-")))


def phase_host(ops):
    """The MonoBeast host-actor path through its entry point, its policy a
    CUDA graph per padded batch (31b's checks, ``phase_graph_policy``);
    returns the kernel launches of the run. Then its parts, alone: one
    env step on
    the CPU (one thread), one batched policy call of 8 observations on
    the card (to the logits on the host), and the two halves of a step (a
    learner batch from the restarted actors, one learner step)."""
    import numpy as np
    import torch

    from repro_torch.envs import gridworld
    from repro_torch.envs.base import HostEnv

    ops.reset_stats()
    runtime, seconds, last = run_trainer(HOST_ARGV)
    launches = ops.stats()
    left = _host_threads()
    if left:
        raise AssertionError(f"host actors left threads alive: {left}")
    # 31b: the policy's graphs, on this run
    phase_graph_policy(runtime, seconds, last)
    if launches["vtrace"] < HOST_STEPS:
        raise AssertionError(f"host path made {launches} vtrace launches, "
                             f"fewer than its {HOST_STEPS} steps")
    loss = float(runtime.metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"host path loss not finite: {loss}")

    env = HostEnv(gridworld.make(), seed=0)
    env.reset()
    t0 = time.perf_counter()
    for i in range(500):
        env.step(i % gridworld.NUM_ACTIONS)
    env_step_us = (time.perf_counter() - t0) / 500 * 1e6
    obs = np.zeros((8,) + gridworld.make().obs_shape, np.float32)
    policy_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        runtime.source._policy(obs)
        policy_ms.append((time.perf_counter() - t0) * 1e3)
    split, _ = split_ms(runtime, reps=3)
    left = _host_threads()
    if left:
        raise AssertionError(f"host actors left threads alive: {left}")
    record = dict(
        env="gridworld", agent="deep", actors=8, T=TRAINER_SHAPE[0],
        B=TRAINER_SHAPE[1], steps=HOST_STEPS, seconds=seconds,
        ms_per_step=seconds / HOST_STEPS * 1e3, launches=launches,
        fps_line=last, loss=loss, threads_left=left, env_step_us=env_step_us,
        torch_threads=torch.get_num_threads(),
        policy_ms=statistics.median(policy_ms[5:]),
        batch_ms=split["unroll_ms"], learner_ms=split["learner_ms"])
    emit("host", **record)
    return record


def _learner_state(runtime):
    """Params and optimizer state of a finished run, on the host."""
    state = {f"params/{k}": v.cpu()
             for k, v in runtime.params.state_dict().items()}
    for key, tensors in runtime.opt_state.items():
        state.update({f"opt_state/{key}/{i}": t.cpu()
                      for i, t in enumerate(tensors)})
    return state


def _bitwise(name, got, want):
    import torch
    if list(got) != list(want):
        raise AssertionError(f"resume {name}: state keys differ")
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"resume {name}: not bitwise equal to the "
                             f"uninterrupted run at {bad[:4]}")


def _quiet(fn):
    """fn() with its stdout captured; returns (result, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().strip().splitlines()


def _checkpoint_cost(train, ckpt_lib, argv, directory, reps=5):
    """Medians of the synchronised host-clock times of snapshot and of
    write_snapshot for a Runtime checkpoint of the run ``argv`` builds
    (learner state and a pipelined source with a rollout in flight), and
    the bytes on disk."""
    import torch
    args = train._parser().parse_args(argv)
    source, _, agent, opt_state, _ = train.build_rl_agent(args)
    for _ in range(2):
        source.next_batch(agent)
    snap_ms, write_ms = [], []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = ckpt_lib.snapshot(
            {"params": agent.state_dict(), "opt_state": opt_state},
            structured={"source": source.state_dict()})
        t1 = time.perf_counter()
        path = os.path.join(directory, f"step_{i}")
        ckpt_lib.write_snapshot(path, snap, {"step": i})
        t2 = time.perf_counter()
        snap_ms.append((t1 - t0) * 1e3)
        write_ms.append((t2 - t1) * 1e3)
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    source.stop()
    return {"snapshot_ms": statistics.median(snap_ms),
            "write_ms": statistics.median(write_ms), "bytes": nbytes}


_REPLAY_STATE = ("buffer", "rng", "last_ids", "served", "hits",
                 "prio_drops")


def _flat_state(tree, path=""):
    """A source state tree as (path, value) pairs, arrays as (dtype,
    shape, bytes): equal lists mean bitwise-equal states."""
    import numpy as np
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_state(tree[k],
                                                             f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat_state(v, f"{path}/{i}")]
    if isinstance(tree, np.ndarray):
        return [(path, tree.dtype.str, tree.shape, tree.tobytes())]
    return [(path, tree)]


def _replay_state(state):
    """The replay part of a ReplaySource state: the whole buffer, the
    sampling generator and the feedback bookkeeping."""
    return _flat_state({k: state[k] for k in _REPLAY_STATE})


def phase_resume(ops, workdir, extra_argv=()):
    """Crash-and-resume and CLI resume on the card, each held bitwise to
    an uninterrupted run; then what a checkpoint costs. With ``--replay``
    in ``extra_argv`` the replay state at the end (buffer, sampling
    generator, feedback bookkeeping) must be bitwise equal too."""
    import shutil

    import torch

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.core.runtime import Runtime
    from repro_torch.launch import train

    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    argv = RESUME_ARGV + list(extra_argv) + ["--steps", str(RESUME_STEPS)]
    replay = "--replay" in extra_argv
    before = ops.stats()["vtrace"]
    t0 = time.perf_counter()
    try:
        def run(extra=(), **kw):
            args = train._parser().parse_args(argv + list(extra))
            source, step_fn, agent, opt_state, extras = \
                train.build_rl_agent(args)
            start = 0
            if args.resume:
                (opt_state, start), _ = _quiet(lambda: train._resume(
                    args, source, agent, opt_state))
            runtime = Runtime(source, step_fn, agent, opt_state,
                              total_steps=RESUME_STEPS, start_step=start,
                              log_every=0, print_fn=lambda line: None,
                              checkpoint_meta=train._checkpoint_meta(args),
                              **kw)
            stop, final = source.stop, {}
            if replay:   # stop() recycles the slots: read them first
                source.stop = lambda: (final.update(source.state_dict()),
                                       stop())
            runtime.run()
            return runtime, final

        def check(name, got):
            runtime, final = got
            _bitwise(name, _learner_state(runtime), want)
            if replay and _replay_state(final) != want_replay:
                raise AssertionError(f"resume {name}: replay state not "
                                     "bitwise equal to the uninterrupted "
                                     "run's")

        first, final = run()
        want = _learner_state(first)
        want_replay = _replay_state(final) if replay else None
        check("second uninterrupted run", run())

        # a crash raised from on_metrics after step CRASH_STEP's update
        crash_dir = os.path.join(workdir, "crash")

        def boom(step, metrics):
            if step == CRASH_STEP:
                raise RuntimeError("killed")

        try:
            run(checkpoint_dir=crash_dir, checkpoint_every=CKPT_EVERY,
                on_metrics=boom)
        except RuntimeError as exc:
            if str(exc) != "killed":
                raise
        else:
            raise AssertionError("the crashing run did not crash")
        latest = ckpt_lib.latest_step_path(crash_dir)
        if os.path.basename(latest) != f"step_{CRASH_STEP + 1}":
            raise AssertionError(f"crash checkpoint is {latest}")
        check("crash-and-resume", run(["--checkpoint-dir", crash_dir,
                                       "--resume"]))

        # the CLI: checkpoints every CLI_EVERY steps, cut back to the first
        # one (as if killed there), then --resume to the same horizon
        cli_dir = os.path.join(workdir, "cli")
        _quiet(lambda: train.main(argv + [
            "--checkpoint-every", str(CLI_EVERY), "--checkpoint-dir",
            cli_dir]))
        shutil.rmtree(os.path.join(cli_dir, f"step_{RESUME_STEPS}"))
        resumed, lines = _quiet(lambda: train.main(argv + [
            "--checkpoint-dir", cli_dir, "--resume"]))
        banner = (f"resumed {cli_dir}/step_{CLI_EVERY} at step {CLI_EVERY} "
                  "(source state restored)")
        if banner not in lines:
            raise AssertionError(f"CLI resume printed {lines[:2]}")
        # the CLI's final checkpoint holds the replay state at the end
        final = ckpt_lib.restore_structured(
            os.path.join(cli_dir, f"step_{RESUME_STEPS}"), "source") \
            if replay else None
        check("CLI resume", (resumed, final))
        seconds = time.perf_counter() - t0
        launches = ops.stats()["vtrace"] - before
        configs = [("catch minatar", argv)] + ([] if replay else [
            ("gridworld deep", ["--env", "gridworld", "--agent", "deep",
                                "--batch", "32"])])
        cost = {name: _checkpoint_cost(
                    train, ckpt_lib, cfg_argv,
                    os.path.join(workdir, f"cost-{name}"))
                for name, cfg_argv in configs}
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    emit("resume", env="catch", agent="minatar", steps=RESUME_STEPS,
         extra_argv=list(extra_argv), crash_step=CRASH_STEP,
         checkpoint_every=CKPT_EVERY, cli_every=CLI_EVERY,
         cudnn_deterministic=True, bitwise=True, leaves=len(want),
         replay_state_entries=len(want_replay) if replay else 0,
         seconds=seconds, vtrace_launches=launches, checkpoint=cost)


def _grad_run(ops, kernel, params, x0, apply):
    """Output, input grad and parameter grads of mean(out^2) for each impl,
    and the kernel's launches on the kernel path."""
    import torch
    runs = {}
    for impl in ("xla", "kernel"):
        params.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        before = ops.stats()[kernel]
        out = apply(params, x, impl)
        torch.mean(torch.square(out)).backward()
        torch.cuda.synchronize()
        runs[impl] = dict(out=out.detach(), input=x.grad,
                          params={n: p.grad.clone()
                                  for n, p in params.named_parameters()},
                          launches=ops.stats()[kernel] - before)
    return runs


def phase_grad(ops):
    """Gradients on the card in float32: one full-width Zamba2-2.7B Mamba2
    layer on a 256-token chunk (the SSD chunk kernel forward, one launch)
    and one full-width Qwen3-4B attention layer at S 512 (the flash-
    attention kernel forward, one launch), weights and input from seed 0.
    The loss mean(out^2) through impl="kernel" (whose backward is the VJP
    of the plain version, as the reference's) against impl="xla": the
    output, the input's gradient and every parameter's gradient must agree
    within MODEL_TOL, as torch.allclose(rtol=MODEL_TOL, atol=MODEL_TOL).
    Returns the max abs errors by layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mamba as mamba_lib

    zcfg = dataclasses.replace(get_config("zamba2-2.7b"), dtype="float32")
    qcfg = dataclasses.replace(get_config("qwen3-4b"), dtype="float32")
    positions = torch.arange(512, device="cuda")
    layers = {
        "zamba2-2.7b mamba2": (
            "ssd_chunk", zcfg,
            lambda gen: mamba_lib.mamba_init(zcfg, generator=gen,
                                             device="cuda"),
            zcfg.ssm_chunk,
            lambda p, x, impl: mamba_lib.mamba_apply(p, x, zcfg,
                                                     impl=impl)[0]),
        "qwen3-4b attention": (
            "flash_attention", qcfg,
            lambda gen: attn_lib.attn_init(qcfg, "attn", generator=gen,
                                           device="cuda"),
            512,
            lambda p, x, impl: attn_lib.attn_apply(
                p, x, cfg=qcfg, kind="attn", positions=positions,
                impl=impl)[0]),
    }
    errors = {}
    for name, (kernel, cfg, init, seq, apply) in layers.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init(gen)
        x0 = torch.randn((1, seq, cfg.d_model), generator=gen,
                         device="cuda")
        runs = _grad_run(ops, kernel, params, x0, apply)
        want, got = runs["xla"], runs["kernel"]
        pairs = [("out", got["out"], want["out"]),
                 ("input", got["input"], want["input"])] + [
            (f"param {n}", got["params"][n], want["params"][n])
            for n in want["params"]]
        err = {}
        for label, g, w in pairs:
            if not torch.isfinite(g).all():
                raise AssertionError(f"grad {name}: {label} not finite")
            err[label] = (g - w).abs().max().item()
            if not torch.allclose(g, w, rtol=MODEL_TOL, atol=MODEL_TOL):
                raise AssertionError(
                    f"grad {name}: {label} max abs err {err[label]:.3e} "
                    f"beyond rtol = atol = {MODEL_TOL}")
        if got["launches"] != 1 or want["launches"] != 0:
            raise AssertionError(f"grad {name}: {kernel} launches "
                                 f"{got['launches']} (kernel path), "
                                 f"{want['launches']} (plain path), want 1, 0")
        errors[name] = dict(
            out=err["out"], input=err["input"],
            params=max(v for k, v in err.items() if k.startswith("param")),
            param_count=len(want["params"]), seq=seq, dtype="float32")
        del params, runs, want, got
        torch.cuda.empty_cache()
    emit("grad", tol=dict(rtol=MODEL_TOL, atol=MODEL_TOL),
         max_abs_err=errors)
    return errors


def remat_step_launches(cfg, seq):
    """Flash-attention and SSD-chunk launches of one learner step over
    ``seq`` tokens with ``cfg.remat``: each layer runs in the forward pass
    and again in its group's recomputation, and a layer of a multi-layer
    group once more in its own (the nested checkpoint); the shared block
    after each group is a one-layer group. But torch's non-reentrant
    checkpoint stops a region's recomputation once it has rebuilt every
    tensor the region's backward saved (its early stop): where nothing
    follows a multi-layer group's last layer inside the group's region
    (Gemma2's pair; Zamba2's shared block follows its Mamba2 layers),
    that layer is not rerun there and runs twice. Without remat each
    layer runs once. A self-attention layer launches flash attention
    once a pass, a Mamba2 layer the SSD chunk kernel once a chunk; xattn
    and the xLSTM mixers launch nothing."""
    from repro_torch.models.attention import CAUSAL_KINDS

    nested = cfg.remat and len(cfg.block_pattern) > 1
    last = len(cfg.block_pattern) - 1
    chunks = -(-seq // cfg.ssm_chunk)
    out = {"flash_attention": 0, "ssd_chunk": 0}
    for idx, (mixer, _) in enumerate(cfg.block_pattern):
        passes = (3 if nested else 2) if cfg.remat else 1
        if nested and idx == last and not cfg.shared_attn_every:
            passes = 2
        if mixer == "mamba":
            out["ssd_chunk"] += passes * chunks * cfg.num_groups
        elif mixer in CAUSAL_KINDS:
            out["flash_attention"] += passes * cfg.num_groups
    if cfg.shared_attn_every:
        out["flash_attention"] += (2 if cfg.remat else 1) * cfg.num_groups
    return out


def _lm_main(ops, argv, probe=None):
    """``train.main(argv)`` with its kernel launches and peak device
    memory (allocated, and reserved with the learner graph's pool); then
    ``split_ms`` on the trained runtime (its medians and last batch), and
    ``probe(params, batch)``, whose dict joins the run's. The run's
    ``compiled:`` line must name the learner step, whose calls (the run's
    steps, then the timed one) share one graph key: the first runs
    eagerly, the second captures (and so a 1-step run's timed call pays
    the capture), the rest replay. The model, optimizer state and graphs are freed
    before it returns: the card's reserved memory must be back within
    LM_RELEASED_BYTES of what it was before the run."""
    import gc

    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    ops.reset_stats()
    runtime, seconds, last = run_trainer(argv)
    launches = ops.stats()
    line = _compiled_line()
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in runtime.metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{argv}: metrics not finite: {metrics}")
    frames, steps = runtime.frames, runtime.total_steps
    split, batch = split_ms(runtime, reps=LM_SPLIT_REPS)
    peak_reserved = torch.cuda.max_memory_reserved()
    captures = runtime.step_fn.captures
    parameters = sum(p.numel() for p in runtime.params.parameters())
    probed = probe(runtime.params, batch) if probe is not None else {}
    del runtime
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_reserved() - reserved0
    if not line.startswith("compiled: the learner step") or captures != 1 \
            or left > LM_RELEASED_BYTES:
        raise AssertionError(
            f"{argv}: {line!r}, {captures} learner captures (want 1), "
            f"{left} bytes still reserved after the run")
    step_ms = split["unroll_ms"] + split["learner_ms"]
    run = dict(argv=argv, seconds=seconds, fps_line=last, compiled=line,
               learner_captures=captures, parameters=parameters,
               metrics=metrics,
               launches=launches, peak_mem_bytes=peak,
               peak_reserved_bytes=peak_reserved, reserved_left_bytes=left,
               frames=frames, split_reps=LM_SPLIT_REPS, **split,
               step_ms=step_ms,
               frames_per_s=frames / steps / step_ms * 1e3, **probed)
    return run, batch, steps


@contextlib.contextmanager
def recorded_aux(seen):
    """Inside: ``seen["aux"]``, the MoE aux (load balance, z-loss, dropped
    fraction, each summed over the layers) of the last ``model.forward``
    call, the one whose router terms a learner step adds to its loss."""
    from repro_torch.models import model as model_lib
    forward = model_lib.forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        seen["aux"] = tuple(float(a.detach()) for a in out[1])
        return out

    model_lib.forward = recording
    try:
        yield seen
    finally:
        model_lib.forward = forward


def _lm_step_check(ops, cfg, batch, make_step, want):
    """One learner step on ``batch`` from seed-0 weights of ``cfg`` (the
    run's config) in float32 activations, through the kernel paths and
    through the plain paths (attention ``xla``, SSD ``xla``, V-trace
    ``scan``). The kernel run must launch exactly ``want``, the plain run
    nothing; the loss and the gradients' global norm must agree within
    MODEL_TOL, and every leaf's largest gradient difference within
    LM_GRAD_TOL of that leaf's largest gradient. The optimizer is a probe
    that keeps the gradients and moves no weight. Every other metric the
    step returns (lm-rl: pg_loss, baseline_loss, entropy_loss), and an MoE
    arch's router terms (load balance, z-loss, dropped fraction), are
    recorded for both paths with their gaps, under no bar.

    An MoE arch's kernel run takes the plain run's routing
    (``pinned_routes``): a token whose top-k probabilities nearly tie may
    pick another expert in the other run, and where capacity binds that
    moves other tokens' slots, which changes an expert's gradient by a
    large share of its own (a few tokens reach each). The bars then hold
    the kernels' arithmetic alone; the tokens the kernel run would have
    routed to another set of experts are counted, with their top-k
    margins, in ``routing``.

    A VLM's batch gets the seeded vision stub beside its tokens, as the
    trainer's step adds its zeros, so that the xattn layers' k and v
    enter the loss."""
    import gc

    import torch

    from repro_torch.models import model as model_lib
    from repro_torch.optim import optimizers

    arch = cfg.name
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.vision_seq:
        batch = dict(batch, vision=vision_stub(
            cfg, batch["tokens"].shape[0], torch.float32))
    params = model_lib.init(cfg, seed=0, device="cuda")
    names = [n for n, _ in params.named_parameters()]
    runs, grads, routes, flips = {}, {}, [], []
    routing = {"plain": lambda: recorded_routes(routes),
               "kernel": lambda: pinned_routes(routes, flips)}
    for path, impl, vtrace in (("plain", "xla", "scan"),
                               ("kernel", "kernel", "kernel")):
        def keep(g, state, plist, step, path=path):
            grads[path] = list(g)
            g.clear()
            return state

        opt = optimizers.Optimizer(init=lambda p: {}, step=keep)
        icfg = dataclasses.replace(cfg, attn_impl=impl, ssd_impl=impl)
        ops.reset_stats()
        seen = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing[path](), recorded_aux(seen):
            _, _, metrics = make_step(icfg, opt, vtrace)(params, {}, 0,
                                                         batch)
        torch.cuda.synchronize()
        others = {k: float(v) for k, v in metrics.items() if k != "loss"}
        if cfg.num_experts:
            others.update(zip(("load_balance", "z_loss", "dropped_frac_sum"),
                              seen["aux"]))
        runs[path] = dict(loss=float(metrics["loss"]),
                          grad_norm=float(optimizers.global_norm(
                              grads[path])),
                          metrics=others,
                          ms=(time.perf_counter() - t0) * 1e3,
                          launches=ops.stats())
        del metrics
        gc.collect()
    routing_report = None
    if cfg.num_experts:
        margins = torch.cat([m for m in flips]) if flips else None
        routing_report = dict(
            pinned=True, calls=len(routes),
            routed_tokens=int(sum(i.shape[0] * i.shape[1]
                                  for i, _ in routes)),
            flips=0 if margins is None else margins.numel(),
            flip_margins=([] if margins is None
                          else sorted(margins.tolist())[:20]))
    del routes, flips
    worst = dict(rel=0.0, leaf=None, abs=0.0, scale=0.0)
    for name, gk, gp in zip(names, grads["kernel"], grads["plain"]):
        diff = (gk - gp).abs().max().item()
        scale = gp.abs().max().item()
        rel = diff / scale if scale else (0.0 if not diff else math.inf)
        if not math.isfinite(diff) or rel > worst["rel"]:
            worst = dict(rel=rel, leaf=name, abs=diff, scale=scale)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    for key in ("loss", "grad_norm"):
        if not (math.isfinite(k[key]) and math.isclose(
                k[key], p[key], rel_tol=MODEL_TOL, abs_tol=MODEL_TOL)):
            raise AssertionError(
                f"{arch} float32 step: kernel-path {key} {k[key]} against "
                f"the plain path's {p[key]}, beyond {MODEL_TOL}")
    if not worst["rel"] <= LM_GRAD_TOL:
        raise AssertionError(
            f"{arch} float32 step: leaf {worst['leaf']} gradients differ by "
            f"{worst['abs']:.3e}, {worst['rel']:.3e} of its largest "
            f"{worst['scale']:.3e}, beyond {LM_GRAD_TOL}")
    want = {**dict.fromkeys(k["launches"], 0), **want}
    if k["launches"] != want:
        raise AssertionError(f"{arch} kernel path launched {k['launches']}, "
                             f"want {want}")
    if any(p["launches"].values()):
        raise AssertionError(f"{arch} plain path launched {p['launches']}")
    return dict(dtype="float32", tol=MODEL_TOL, grad_tol=LM_GRAD_TOL,
                kernel=k, plain=p, loss_diff=abs(k["loss"] - p["loss"]),
                grad_norm_diff=abs(k["grad_norm"] - p["grad_norm"]),
                metric_diffs={key: abs(v - p["metrics"][key])
                              for key, v in k["metrics"].items()},
                worst_leaf=worst, routing=routing_report)


def _arg(argv, flag):
    return argv[argv.index(flag) + 1]


def router_probe(cfg, tokens_of):
    """A ``_lm_main`` probe: the MoE router's load-balance and z-loss
    (summed over layers, as the learner's loss takes them) of the trained
    weights on the run's last batch, through the plain attention path;
    ``cfg``: the run's config (its depth cut too)."""
    arch = cfg.name
    cfg = dataclasses.replace(cfg, attn_impl="xla")

    def probe(params, batch):
        import torch

        from repro_torch.models import model as model_lib

        with torch.no_grad():
            _, aux, _ = model_lib.forward(params, tokens_of(batch), cfg=cfg)
        lb, zl, dropped = (float(a) for a in aux)
        if not all(math.isfinite(v) for v in (lb, zl, dropped)):
            raise AssertionError(f"{arch} router aux not finite: "
                                 f"{lb}, {zl}, {dropped}")
        return dict(load_balance=lb, z_loss=zl, dropped_frac_sum=dropped)
    return probe


def run_config(argv):
    """The config ``train.main(argv)`` builds its LM run from
    (``train._lm_config``: published or reduced, impls folded in, and cut
    in depth inside ``depth_cut``)."""
    from repro_torch.launch import train
    return train._lm_config(train._parser().parse_args(argv))


def phase_lm_rl(ops, argv=LM_RL_ARGV, phase="lm_rl"):
    """``--mode lm-rl`` at full width through the entry point (Qwen3-4B
    by default; bf16 activations on float32 weights, AdamW, the settings
    of ``train.build_lm_rl``): ``--steps`` steps of 8 episodes of 64
    tokens (1 since the script's time was cut), each
    generated by the decode session (flash attention in the prefill,
    decode attention in every layer of every step) and learned from with
    the flash-attention kernel under autograd (twice a layer: remat) and
    the V-trace kernel. Then the kernel-against-plain check of one float32
    step on the last batch that ``split_ms`` drew. An MoE arch also
    reports its router losses. Returns the main run's launches."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import learner, sources

    arch = _arg(argv, "--arch")
    cfg = run_config(argv)
    probe = router_probe(cfg, lambda b: b["obs"].T[:, :-1]) \
        if cfg.num_experts else None
    run, batch, steps = _lm_main(ops, argv, probe)
    t, b = int(_arg(argv, "--seq")), int(_arg(argv, "--batch"))
    layers, _ = kernel_layers(cfg)
    learner_launches = {**remat_step_launches(cfg, t), "vtrace": 1}
    want = {"vtrace": steps, "ssd_chunk": 0,
            "flash_attention": (layers + learner_launches["flash_attention"])
            * steps, "decode_attention": layers * (t - 1) * steps}
    loss_cfg = TrainConfig(entropy_cost=0.003)  # build_lm_rl's loss costs

    def make_step(cfg, opt, vtrace):
        return sources.lm_rl_step_from_rollout(learner.make_lm_train_step(
            cfg, opt, loss_cfg, loss_chunk=t, vtrace_impl=vtrace))

    check = _lm_step_check(ops, cfg, batch, make_step, learner_launches)
    emit(phase, arch=arch, groups=cfg.num_groups, T=t, B=b,
         want_launches=want, check=check, **run)
    if run["launches"] != want:
        raise AssertionError(f"{phase} launches {run['launches']}, want "
                             f"{want} ({layers} layers, {steps} steps)")
    return run["launches"]


def phase_lm(ops, argv=LM_ARGV, phase="lm"):
    """``--mode lm`` through the entry point (Zamba2-2.7B at full width by
    default): pretraining steps of 4 x 512 tokens on the synthetic corpus
    (bf16 activations on float32 weights, AdamW), the SSD chunk kernel in
    every Mamba2 layer (two chunks a sequence) and flash attention in
    every attention layer, both under autograd and run again by remat's
    recomputation. Then, where a step launches a kernel, the
    kernel-against-plain check of one float32 step on the last batch that
    ``split_ms`` drew, at the run's config. An MoE arch also reports its
    router losses. Returns the main run's launches."""
    from repro_torch.core import learner

    cfg = run_config(argv)
    probe = router_probe(cfg, lambda b: b["tokens"][:, :-1]) \
        if cfg.num_experts else None
    run, batch, steps = _lm_main(ops, argv, probe)
    launches = run["launches"]
    seq = int(_arg(argv, "--seq"))
    per_step = remat_step_launches(cfg, seq)
    want = {"vtrace": 0, "decode_attention": 0,
            **{k: v * steps for k, v in per_step.items()}}

    def make_step(cfg, opt, vtrace):
        del vtrace
        return learner.make_lm_pretrain_step(cfg, opt, loss_chunk=seq)

    check = (_lm_step_check(ops, cfg, batch, make_step, per_step)
             if any(per_step.values()) else None)
    emit(phase, arch=cfg.name, groups=cfg.num_groups, seq=seq,
         tokens_per_step=run["frames"] // steps,
         tokens_per_s=run.pop("frames_per_s"), want_launches=want,
         check=check, **run)
    if launches != want:
        raise AssertionError(f"{phase} launches {launches}, want {want}")
    return launches


# ---------------------------------------------------------------------------
# 17. data parallel (--mesh-data)


@contextlib.contextmanager
def vtrace_shapes(ops):
    """Records the (T, B) of every V-trace wrapper call made inside (the
    losses look the wrapper up at each call)."""
    shapes = []
    fn = ops.vtrace_from_importance_weights_kernel

    def recorded(log_rhos, *args, **kwargs):
        shapes.append(tuple(log_rhos.shape))
        return fn(log_rhos, *args, **kwargs)

    ops.vtrace_from_importance_weights_kernel = recorded
    try:
        yield shapes
    finally:
        ops.vtrace_from_importance_weights_kernel = fn


@contextlib.contextmanager
def cudnn_deterministic():
    import torch
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags


def _dp_steps(ops, mesh, reverse=False):
    """DP_STEPS learner steps of the full-width deep agent (weights from
    seed 0, Table G.1 RMSProp) on this rank's block of phase 4's seeded
    batch (``reverse``: its columns in reverse order, the same losses in
    exact arithmetic); ``mesh`` None is the plain step. Returns the
    losses, the final learner state on the host, the V-trace shapes,
    synchronised step ms and (under a mesh) the CUDA-event ms of one
    gradient all-reduce."""
    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE, TRAIN
    from repro_torch.core import learner as learner_lib
    from repro_torch.distributed import sharding
    from repro_torch.models.convnet import impala_deep
    from repro_torch.optim import make_optimizer

    device = torch.device("cuda") if mesh is None else mesh.device
    batch = synthetic_batch(torch.Generator(device=device).manual_seed(0),
                            TRAIN.unroll_length, TRAIN.batch_size)
    if reverse:
        batch = {k: v.flip(1) for k, v in batch.items()}
    if mesh is not None:
        batch = sharding.shard_rollout(batch, mesh)
    agent = impala_deep(OBS_SHAPE, NUM_ACTIONS,
                        generator=torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(TRAIN)
    step_fn = learner_lib.make_train_step(opt, TRAIN, vtrace_impl="kernel",
                                          mesh=mesh)
    opt_state = opt.init(list(agent.parameters()))
    losses, step_ms = [], []
    with vtrace_shapes(ops) as shapes:
        for step in range(DP_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            agent, opt_state, metrics = step_fn(agent, opt_state, step,
                                                batch)
            torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
    allreduce_ms = None
    if mesh is not None:
        grads = [torch.randn_like(p) for p in agent.parameters()]
        allreduce_ms = event_ms(lambda: sharding.replicate(grads, mesh),
                                reps=20)
    state = {f"params/{k}": v.cpu() for k, v in agent.state_dict().items()}
    for key, tensors in opt_state.items():
        state.update({f"opt_state/{key}/{i}": t.cpu()
                      for i, t in enumerate(tensors)})
    return {"losses": losses, "state": state, "shapes": shapes,
            "step_ms": step_ms, "allreduce_ms": allreduce_ms}


def phase_dp(ops):
    """17a: world size 1 through NCCL, in this process: DP_STEPS steps of
    the data-parallel learner, bitwise the plain step's losses and
    learner state on the same batch (cuDNN pinned deterministic for
    both), one K1 launch a step at DP_SHAPE; then the plain step on the
    batch's columns reversed, whose loss gaps measure how far a reorder
    of float32 sums alone moves this learner. Returns its record."""
    from repro_torch.launch import mesh as mesh_lib
    with cudnn_deterministic():
        plain = _dp_steps(ops, None)
        reverse = _dp_steps(ops, None, reverse=True)
        with mesh_lib.make_data_mesh(1, "cuda:0",
                                     port=mesh_lib.free_port()) as mesh:
            backend = mesh.backend
            ops.reset_stats()
            dp = _dp_steps(ops, mesh)
            launches = ops.stats()["vtrace"]
    if dp["losses"] != plain["losses"]:
        raise AssertionError(f"17a: losses {dp['losses']} are not bitwise "
                             f"the plain step's {plain['losses']}")
    _bitwise("17a: data-parallel learner at world size 1",
             dp["state"], plain["state"])
    if launches != DP_STEPS or dp["shapes"] != [DP_SHAPE] * DP_STEPS:
        raise AssertionError(f"17a: {launches} V-trace launches at "
                             f"{dp['shapes']}, not {DP_STEPS} at {DP_SHAPE}")
    record = dict(world_size=1, backend=backend, steps=DP_STEPS,
                  losses=dp["losses"], bitwise=True, launches=launches,
                  shapes=[list(x) for x in dp["shapes"]],
                  step_ms=dp["step_ms"], plain_step_ms=plain["step_ms"],
                  steady_step_ms=statistics.median(dp["step_ms"][1:]),
                  plain_steady_step_ms=statistics.median(
                      plain["step_ms"][1:]),
                  allreduce_ms=dp["allreduce_ms"],
                  reverse_losses=reverse["losses"],
                  reverse_gaps=[abs(a - b) for a, b in zip(
                      reverse["losses"], plain["losses"])],
                  grad_floats=sum(v.numel() for k, v in dp["state"].items()
                                  if k.startswith("params/")))
    emit("dp", **record)
    return record


def _dp2_rank(mesh):
    """17b's body in each rank (spawned: it pins float32 and cuDNN itself
    and counts its own launches); returns every rank's record on rank
    0."""
    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    repro_torch.resolve_device("cuda")
    with cudnn_deterministic():
        ops.reset_stats()
        out = _dp_steps(ops, mesh)
        out["launches"] = ops.stats()["vtrace"]
    return sharding.gather_to_main(out, mesh)


def phase_dp2(base):
    """17b: two ranks sharing cuda:0 through gloo over CUDA tensors (NCCL
    refuses two ranks on one device), rank 1 spawned: DP_STEPS steps of
    B 16 each on phase 4's batch. The first loss (before any update) must
    lie within DP_RTOL / DP_ATOL of 17a's (``base``), each later one
    within that or DP_REORDER_FACTOR times 17a's reverse gap at its step;
    both ranks' learner state must be bitwise equal, and each rank must
    launch K1 once a step at DP2_SHAPE. Gloo stages CUDA tensors through
    the host: its times are not a speed figure. Returns each rank's
    launches."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_dp2_rank, 2, device="cuda",
                            devices=["cuda:0", "cuda:0"], backend="gloo",
                            timeout_s=300)
    seconds = time.perf_counter() - t0
    bars = [DP_ATOL + DP_RTOL * abs(b) if s == 0 else max(
        DP_ATOL + DP_RTOL * abs(b), DP_REORDER_FACTOR * gap)
        for s, (b, gap) in enumerate(zip(base["losses"],
                                         base["reverse_gaps"]))]
    for rank, r in enumerate(ranks):
        if r["launches"] != DP_STEPS or \
                r["shapes"] != [DP2_SHAPE] * DP_STEPS:
            raise AssertionError(
                f"17b rank {rank}: {r['launches']} V-trace launches at "
                f"{r['shapes']}, not {DP_STEPS} at {DP2_SHAPE}")
        if not all(abs(a - b) <= bar for a, b, bar in zip(
                r["losses"], base["losses"], bars)):
            raise AssertionError(f"17b rank {rank}: losses {r['losses']} "
                                 f"against 17a's {base['losses']}, bars "
                                 f"{bars}")
    _bitwise("17b: rank 1 against rank 0", ranks[1]["state"],
             ranks[0]["state"])
    emit("dp2", world_size=2, backend="gloo", device="cuda:0 (both ranks)",
         steps=DP_STEPS, losses=ranks[0]["losses"],
         losses_17a=base["losses"],
         gaps=[abs(a - b) for a, b in zip(ranks[0]["losses"],
                                          base["losses"])],
         reverse_gaps_17a=base["reverse_gaps"], bars=bars,
         ranks_bitwise=True,
         launches=[r["launches"] for r in ranks],
         shapes=[list(x) for x in ranks[0]["shapes"]],
         step_ms=[r["step_ms"] for r in ranks],
         allreduce_ms=[r["allreduce_ms"] for r in ranks],
         timing="gloo's host-staging path, not a speed figure",
         seconds=seconds, cuda_visible=torch.cuda.device_count())
    return [r["launches"] for r in ranks]


def phase_dp_trainer(ops):
    """17c: repro_torch.launch.train.main with --mesh-data 1 (NCCL) on
    phase 5's run, then with --replay elite and with --actors host; each
    run's K1 launches must equal its steps. Returns them by run."""
    runs, launches = {}, {}
    for name, argv in (("trainer", TRAINER_ARGV),
                       ("replay", TRAINER_ARGV + ["--replay", "elite"]),
                       ("host", HOST_ARGV)):
        steps = int(argv[argv.index("--steps") + 1])
        ops.reset_stats()
        runtime, seconds, last = run_trainer(argv + ["--mesh-data", "1"])
        launches[name] = ops.stats()["vtrace"]
        left = _host_threads()
        loss = float(runtime.metrics["loss"])
        source = type(getattr(runtime.source, "inner", runtime.source))
        if runtime.mesh is None or runtime.mesh.size != 1:
            raise AssertionError(f"17c {name}: the run built no mesh")
        if launches[name] != steps:
            raise AssertionError(f"17c {name}: {launches[name]} V-trace "
                                 f"launches in {steps} steps")
        if left or not math.isfinite(loss):
            raise AssertionError(f"17c {name}: threads left {left}, loss "
                                 f"{loss}")
        runs[name] = dict(argv=argv + ["--mesh-data", "1"],
                          source=source.__name__,
                          backend=runtime.mesh.backend, steps=steps,
                          launches=launches[name], seconds=seconds,
                          ms_per_step=seconds / steps * 1e3, loss=loss,
                          fps_line=last)
    emit("dp_trainer", runs=runs)
    return launches


def phase_dp_resume(ops, workdir):
    """17d: phase 8's Catch run with --mesh-data 1, cuDNN pinned
    deterministic: the CLI checkpointed every CLI_EVERY steps, cut back
    to the first and resumed, against the uninterrupted run — learner
    state and the sharded source's state bitwise; the learner state also
    bitwise the single-process run's. Returns K1's launches (the three
    mesh runs: RESUME_STEPS x 2 + the resumed steps)."""
    import shutil

    import numpy as np

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.launch import train

    argv = RESUME_ARGV + ["--steps", str(RESUME_STEPS)]
    dp_argv = argv + ["--mesh-data", "1"]
    dirs = {k: os.path.join(workdir, k) for k in ("whole", "cli", "plain")}
    final = f"step_{RESUME_STEPS}"
    with cudnn_deterministic():
        ops.reset_stats()
        t0 = time.perf_counter()
        _quiet(lambda: train.main(dp_argv + ["--checkpoint-dir",
                                             dirs["whole"]]))
        _quiet(lambda: train.main(dp_argv + [
            "--checkpoint-every", str(CLI_EVERY), "--checkpoint-dir",
            dirs["cli"]]))
        shutil.rmtree(os.path.join(dirs["cli"], final))
        _, lines = _quiet(lambda: train.main(dp_argv + [
            "--checkpoint-dir", dirs["cli"], "--resume"]))
        seconds = time.perf_counter() - t0
        launches = ops.stats()["vtrace"]
        _quiet(lambda: train.main(argv + ["--checkpoint-dir",
                                          dirs["plain"]]))
    banner = (f"resumed {dirs['cli']}/step_{CLI_EVERY} at step {CLI_EVERY} "
              "(source state restored)")
    if banner not in lines:
        raise AssertionError(f"17d: CLI resume printed {lines[:2]}")
    read = {k: ckpt_lib.load_flat(os.path.join(d, final))[0]
            for k, d in dirs.items()}

    def same(a, b):
        return a.keys() == b.keys() and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a)

    if not same(read["cli"], read["whole"]):
        raise AssertionError("17d: resumed learner state is not bitwise "
                             "the uninterrupted run's")
    if not same(read["whole"], read["plain"]):
        raise AssertionError("17d: --mesh-data 1 learner state is not "
                             "bitwise the single-process run's")
    states = [ckpt_lib.restore_structured(os.path.join(dirs[k], final),
                                          "source") for k in ("cli", "whole")]
    if states[0]["kind"] != "ShardedDeviceSource" or \
            _flat_state(states[0]) != _flat_state(states[1]):
        raise AssertionError("17d: the sharded source's state is not "
                             "bitwise the uninterrupted run's")
    want = 2 * RESUME_STEPS + RESUME_STEPS - CLI_EVERY
    if launches != want:
        raise AssertionError(f"17d: {launches} V-trace launches, not "
                             f"{want}")
    emit("dp_resume", argv=dp_argv, cli_every=CLI_EVERY,
         cudnn_deterministic=True, bitwise=True, leaves=len(read["whole"]),
         source_entries=len(_flat_state(states[0])), launches=launches,
         seconds=seconds)
    return launches



# ---------------------------------------------------------------------------
# 18. the recurrent agent; 19-21. Granite-3.0-1B-A400M (MoE) at full width


def recurrent_batch(gen, t, b, core):
    """``synthetic_batch`` with the recurrent learner's inputs: pre_done
    (T+1, B), the done flags shifted by one step after a carried first
    row, and a core_state (h, c) drawn from ``gen``."""
    import torch

    batch = synthetic_batch(gen, t, b)
    first = torch.rand((1, b), generator=gen, device="cuda") < 0.01
    batch["pre_done"] = torch.cat([first, batch["done"]])
    batch["core_state"] = tuple(
        0.1 * torch.randn((b, core), generator=gen, device="cuda")
        for _ in range(2))
    return batch


def relearned_logits(agent, rollout):
    """The recurrent learner's re-run of a rollout's T+1 steps from its
    initial core_state (the torso once, the cell in a loop)."""
    import torch

    with torch.no_grad():
        feats = agent.features(rollout["obs"])
        state, logits = rollout["core_state"], []
        for t in range(feats.shape[0]):
            out = agent.cell(feats[t], state, rollout["pre_done"][t])
            state = out.core_state
            logits.append(out.policy_logits)
    return torch.stack(logits)


def phase_recurrent(ops):
    """18a: the recurrent agent (MinAtar torso, LSTM core 128) on Catch at
    B 32, T 20: 3 unrolls on the card, each followed by a learner step
    through K1; every loss finite, the learner's re-run reproducing the
    behaviour logits within VTRACE_TOL, one K1 launch a step. 18b: the
    same agent on full-width inputs (84x84x4, 18 actions, T 80, B 32,
    Table G.1 RMSProp): 3 learner steps on a seeded synthetic recurrent
    rollout, the first loss against the plain-loop V-trace's within 1e-4
    (phase 4's bar). Returns K1's launches and (T, B) of each."""
    import copy

    import torch

    from repro_torch.configs.atari_impala import (NUM_ACTIONS, OBS_SHAPE,
                                                  TRAIN, small_train)
    from repro_torch.core import compiled
    from repro_torch.core import learner as learner_lib
    from repro_torch.core import rollout as rollout_lib
    from repro_torch.envs import catch
    from repro_torch.models.convnet import minatar_lstm_net
    from repro_torch.optim import make_optimizer

    out = {}
    # 18a: Catch, unroll + learner
    t, b = TRAINER_SHAPE
    env = catch.make()
    tc = small_train(unroll_length=t, batch_size=b, learning_rate=2e-3,
                     total_steps=RECURRENT_STEPS)
    agent = minatar_lstm_net(env.obs_shape, env.num_actions,
                             generator=torch.Generator().manual_seed(0))
    agent = agent.cuda()
    opt = make_optimizer(tc)
    opt_state = opt.init(list(agent.parameters()))
    # the learner step and the unroll as CUDA graphs (compiled.TrainStep,
    # compiled.Unroll: warmed, captured, replayed)
    step_fn = compiled.TrainStep(
        learner_lib.make_recurrent_train_step(opt, tc), opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    env_state, obs = rollout_lib.env_reset_batch(env, gen, b, "cuda")
    unroll = rollout_lib.make_recurrent_unroll(env, t)
    actors = compiled.Unroll(unroll, unroll.initial_carry(agent, env_state,
                                                          obs), gen)
    losses, errs, step_ms = [], [], []
    ops.reset_stats()
    for step in range(RECURRENT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ro = actors(agent)
        errs.append((relearned_logits(agent, ro)[:t]
                     - ro["behavior_logits"]).abs().max().item())
        agent, opt_state, metrics = step_fn(agent, opt_state, step, ro)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.stats()["vtrace"]
    emit("recurrent", part="catch", T=t, B=b, core=agent.core_size,
         losses=losses, relearn_max_abs_err=errs, tol=VTRACE_TOL,
         step_ms=step_ms, vtrace_launches=launches)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"18a: recurrent loss not finite: {losses}")
    if not max(errs) <= VTRACE_TOL:
        raise AssertionError(f"18a: the learner's re-run is {max(errs):.3e} "
                             "off the behaviour logits")
    if launches != RECURRENT_STEPS:
        raise AssertionError(f"18a: {launches} V-trace launches for "
                             f"{RECURRENT_STEPS} steps")
    out["catch"] = dict(launches=launches, shape=[t, b])
    del agent, opt_state, actors, ro

    # 18b: full width, synthetic recurrent rollouts
    t, b = TRAIN.unroll_length, TRAIN.batch_size
    agent = minatar_lstm_net(OBS_SHAPE, NUM_ACTIONS,
                             generator=torch.Generator().manual_seed(0))
    agent = agent.cuda()
    batch = recurrent_batch(torch.Generator(device="cuda").manual_seed(0),
                            t, b, agent.core_size)
    opt = make_optimizer(TRAIN)
    scan_agent = copy.deepcopy(agent)
    _, _, scan_metrics = learner_lib.make_recurrent_train_step(
        opt, TRAIN, vtrace_impl="scan")(
        scan_agent, opt.init(list(scan_agent.parameters())), 0, batch)
    scan_loss = float(scan_metrics["loss"])
    del scan_agent
    step_fn = compiled.TrainStep(
        learner_lib.make_recurrent_train_step(opt, TRAIN), opt)
    opt_state = opt.init(list(agent.parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_stats()
    losses, step_ms = [], []
    for step in range(RECURRENT_STEPS):
        t0 = time.perf_counter()
        agent, opt_state, metrics = step_fn(agent, opt_state, step, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = ops.stats()["vtrace"]
    peak = torch.cuda.max_memory_allocated()
    emit("recurrent", part="full_width", obs=list(OBS_SHAPE),
         actions=NUM_ACTIONS, T=t, B=b, core=agent.core_size,
         params=sum(x.numel() for x in agent.parameters()), losses=losses,
         scan_loss=scan_loss, step_ms=step_ms,
         steady_step_ms=statistics.median(step_ms[1:]),
         vtrace_launches=launches, peak_mem_bytes=peak)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"18b: recurrent loss not finite: {losses}")
    if not math.isclose(losses[0], scan_loss, rel_tol=1e-4, abs_tol=1e-4):
        raise AssertionError(f"18b: kernel-path loss {losses[0]} != "
                             f"scan-path loss {scan_loss}")
    if launches != RECURRENT_STEPS:
        raise AssertionError(f"18b: {launches} V-trace launches for "
                             f"{RECURRENT_STEPS} steps")
    out["full_width"] = dict(launches=launches, shape=[t, b])
    del agent, opt_state, batch
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recorded_moe_aux(log):
    """Append (the tokens' shape, dropped fraction) of every MoE layer
    call inside the block to the list ``log``."""
    from repro_torch.models import moe
    apply = moe.moe_apply

    def recording(params, x, cfg):
        out, aux = apply(params, x, cfg)
        log.append((tuple(x.shape[:2]), aux.dropped_frac))
        return out, aux

    moe.moe_apply = recording
    try:
        yield log
    finally:
        moe.moe_apply = apply


def phase_gserve(ops):
    """20: the Granite server at full width through ``serve.main``
    (phase 10's check: every request served and echoed, K2 once a layer
    an admission and K3 once a layer a step), and the mean fraction of
    token-slots the MoE layers dropped at decode (8 slots, idle ones
    included, through 32 experts of capacity 4) and at admission."""
    import torch

    with recorded_moe_aux([]) as log:
        launches = phase_serve(ops, GSERVE_ARGV)
    decode = [d for shape, d in log if shape[1] == 1]
    prefill = [d for shape, d in log if shape[1] > 1]
    emit("gserve", argv=GSERVE_ARGV, moe_calls=len(log),
         decode_dropped_frac_mean=torch.stack(decode).mean().item(),
         prefill_dropped_frac_mean=(torch.stack(prefill).mean().item()
                                    if prefill else None))
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def recorded_mixers(log):
    """Append (kind, input, output) to the list ``log`` for every call of
    a recurrent mixer's apply or decode made inside the block, in call
    order."""
    from repro_torch.models import blocks
    saved = dict(blocks._RECURRENT)

    def recording(kind, fn):
        def call(params, h, *args, **kw):
            out = fn(params, h, *args, **kw)
            log.append((kind, h, out[0]))
            return out
        return call

    for kind, (init, apply, decode, cache_init) in saved.items():
        blocks._RECURRENT[kind] = (init, recording(kind, apply),
                                   recording(kind, decode), cache_init)
    try:
        yield
    finally:
        blocks._RECURRENT.update(saved)


def _rel_gap(got, want):
    """(largest |got - want|, that over the largest |want|)."""
    diff = (got - want).abs().max().item()
    return diff, diff / want.abs().max().item()


def xlstm_decode_gap(cfg, seed, b, s, p):
    """The forward of ``b`` x ``s`` tokens against a prefill of ``p``
    tokens and ``s - p`` teacher-forced decode steps, weights and tokens
    from ``seed``: the logits' largest gap, their scale, and for each
    layer the gap of its mixer's output at the decoded positions, as the
    model ran (``carried``: the layers below feed it what they computed)
    and alone (``alone``: its prefill and decode steps on the forward's
    own input to it). Each gap is also given over its output's largest
    magnitude. With the forward, prefill and decode times."""
    import numpy as np
    import torch

    from repro_torch.models import blocks
    from repro_torch.models import model as model_lib

    params = model_lib.init(cfg, seed=seed, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s))).cuda()
    fwd_log, dec_log = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_mixers(fwd_log):
            full, _, _ = model_lib.apply_lm(params, tokens, cfg=cfg)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        want = full[:, p:].clone()
        del full
        t0 = time.perf_counter()
        _, _, cache = model_lib.prefill(params, tokens[:, :p], cfg=cfg,
                                        cache_seq_len=s)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        steps = []
        t0 = time.perf_counter()
        with recorded_mixers(dec_log):
            for t in range(p, s):
                lg, _, cache = model_lib.serve_step(
                    params, tokens[:, t:t + 1], cache, t, cfg=cfg)
                steps.append(lg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (s - p)
        got = torch.cat(steps, dim=1)
        diff, rel = _rel_gap(got, want)
        finite = bool(torch.isfinite(got).all())
        state_dtypes = sorted({str(v.dtype) for layer in
                               cache["block"].values()
                               for v in layer.values()})
        layers = []
        width = len(cfg.block_pattern)
        for i, (kind, h, out) in enumerate(fwd_log):
            decoded = torch.cat([o for _, _, o in dec_log[i::len(fwd_log)]],
                                dim=1)
            carried = _rel_gap(decoded, out[:, p:])
            mixer = params["blocks"][i // width][f"l{i % width}"]["mixer"]
            _, apply, decode, _ = blocks._RECURRENT[kind]
            _, st = apply(mixer, h[:, :p], cfg, return_state=True)
            alone = torch.cat([decode(mixer, h[:, t:t + 1], st, cfg)[0]
                               for t in range(p, s)], dim=1)
            layers.append(dict(layer=i, kind=kind, carried=carried,
                               alone=_rel_gap(alone, out[:, p:])))
    del params, cache, want, got, fwd_log, dec_log
    torch.cuda.empty_cache()
    return dict(seed=seed, max_abs_logit_diff=diff,
                logit_scale=diff / rel if rel else 0.0, rel_logit_diff=rel,
                finite=finite, state_dtypes=state_dtypes, layers=layers,
                forward_ms=forward_ms, prefill_ms=prefill_ms,
                decode_ms_per_step=decode_ms)


def phase_xlstm(ops):
    """22: xLSTM-125M at full width in float32, weights from seed 0. The
    forward of 4 x 512 tokens (8 mLSTM chunks) against a prefill of 448
    tokens and 64 teacher-forced decode steps: the logits at those 64
    positions within XLSTM_LOGIT_RTOL of their largest magnitude, on
    weights and tokens from seeds 0 and 1, and each layer's mixer alone
    within XLSTM_LAYER_RTOL of its output's (``xlstm_decode_gap``, which
    also gives each layer's gap as the model ran). Then one full-width mLSTM
    layer, chunkwise ``mlstm_apply`` against the sequential
    ``mlstm_reference`` on 512 tokens, within XLSTM_TOL. No kernel may
    launch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models import xlstm

    cfg = dataclasses.replace(get_config(XLSTM), dtype="float32")
    b, s, p = 4, 512, 448
    ops.reset_stats()
    gaps = [xlstm_decode_gap(cfg, seed, b, s, p) for seed in (0, 1)]
    params = model_lib.init(cfg, seed=0, device="cuda")
    with torch.no_grad():
        # one full-width mLSTM layer: chunkwise against sequential
        layer = params["blocks"][0]["l0"]["mixer"]
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = 0.5 * torch.randn((b, s, cfg.d_model), generator=gen,
                              device="cuda")
        y_chunk, st_chunk = xlstm.mlstm_apply(layer, x, cfg,
                                              return_state=True)
        y_seq, st_seq = xlstm.mlstm_reference(layer, x, cfg)
        mlstm_diff = (y_chunk - y_seq).abs().max().item()
        # the state relative to its largest entry (C sums 512 outer
        # products, rescaled by the stabiliser)
        state_diff = ((st_chunk["C"] - st_seq["C"]).abs().max()
                      / st_seq["C"].abs().max().clamp(min=1.0)).item()
    launches = ops.stats()
    emit("xlstm", arch=cfg.name, dtype=cfg.dtype,
         params=sum(x.numel() for x in params.parameters()),
         layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
         chunk=cfg.xlstm_chunk, batch=b, seq=s, prefill_len=p,
         teacher_forced_steps=s - p, rel_tol=XLSTM_LOGIT_RTOL,
         layer_rel_tol=XLSTM_LAYER_RTOL, seeds=gaps,
         max_abs_logit_diff=gaps[0]["max_abs_logit_diff"],
         forward_ms=gaps[0]["forward_ms"], prefill_ms=gaps[0]["prefill_ms"],
         decode_ms_per_step=gaps[0]["decode_ms_per_step"],
         mlstm_max_abs_diff=mlstm_diff, mlstm_state_C_max_rel_diff=state_diff,
         mlstm_tol=XLSTM_TOL, launches=launches)
    del params, x
    torch.cuda.empty_cache()
    if any(launches.values()):
        raise AssertionError(f"the xLSTM path launched {launches}; it has "
                             "no kernel")
    for gap in gaps:
        if not gap["finite"]:
            raise AssertionError("xLSTM decode logits not finite")
        if not gap["rel_logit_diff"] <= XLSTM_LOGIT_RTOL:
            raise AssertionError(
                f"xLSTM prefill + decode logits (seed {gap['seed']}) differ "
                f"from the forward's by {gap['max_abs_logit_diff']:.3e}, "
                f"{gap['rel_logit_diff']:.3e} of their largest "
                f"{gap['logit_scale']:.3e} > {XLSTM_LOGIT_RTOL}")
        worst = max(gap["layers"], key=lambda g: g["alone"][1])
        if not worst["alone"][1] <= XLSTM_LAYER_RTOL:
            raise AssertionError(
                f"xLSTM layer {worst['layer']} ({worst['kind']}, seed "
                f"{gap['seed']}) alone: prefill + decode differ from the "
                f"forward by {worst['alone'][1]:.3e} of its output's "
                f"largest > {XLSTM_LAYER_RTOL}")
        if gap["state_dtypes"] != ["torch.float32"]:
            raise AssertionError(f"xLSTM decode state in "
                                 f"{gap['state_dtypes']}")
    if not (mlstm_diff <= XLSTM_TOL and state_diff <= XLSTM_TOL):
        raise AssertionError(f"mlstm_apply against mlstm_reference: "
                             f"{mlstm_diff:.3e}, C {state_diff:.3e} (of its "
                             f"largest) > "
                             f"{XLSTM_TOL}")


def phase_vlm(ops):
    """25: Llama-3.2-Vision-90B at every published width with VLM_GROUPS
    of its 20 groups. Float32: the kernel path against the plain path
    (``phase_model``: K2 in the self-attention layers, xattn plain). bf16:
    ``generate(vision=)`` at B 4, VLM_PROMPT-token prompts and VLM_GEN
    tokens, K2 once a self-attention layer and K3 once such a layer a
    step; prefill ms and ms a decode step from a second call that stops
    after the prefill. Then 2 steps of ``--mode lm`` on the reduced
    config, K2 exact, with its float32 kernel-against-plain step. Returns
    (generate's launches, the lm run's)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import generate
    from repro_torch.models import model as model_lib

    phase_model(ops, VLM, VLM_PROMPT, phase="vlm", groups=VLM_GROUPS)
    cfg = dataclasses.replace(get_config(VLM), num_groups=VLM_GROUPS,
                              attn_impl="kernel")
    params = model_lib.init(cfg, seed=0, device="cuda")
    b = 4
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (b, VLM_PROMPT))
    vision = vision_stub(cfg, b, torch.bfloat16)
    attn, _ = kernel_layers(cfg)

    def timed(num_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate.generate(params, prompt, 0, cfg=cfg,
                                num_steps=num_steps, vision=vision)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    timed(2)                                   # warm up
    prefill_out, prefill_ms = timed(1)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_stats()
    out, total_ms = timed(VLM_GEN)
    launches = ops.stats()
    peak = torch.cuda.max_memory_allocated()
    want = {"vtrace": 0, "ssd_chunk": 0, "flash_attention": attn,
            "decode_attention": attn * (VLM_GEN - 1)}
    finite = all(bool(torch.isfinite(out[k]).all())
                 for k in ("logprob", "entropy", "baseline"))
    same_first = torch.equal(out["tokens"][:, :VLM_PROMPT + 1],
                             prefill_out["tokens"])
    emit("vlm_generate", arch=cfg.name, dtype=cfg.dtype,
         num_groups=cfg.num_groups,
         published_groups=get_config(VLM).num_groups,
         params=sum(x.numel() for x in params.parameters()), batch=b,
         prompt_len=VLM_PROMPT, gen_tokens=VLM_GEN,
         vision_seq=cfg.vision_seq, prefill_ms=prefill_ms,
         decode_ms_per_step=(total_ms - prefill_ms) / (VLM_GEN - 1),
         total_ms=total_ms, tokens_per_s=b * VLM_GEN / total_ms * 1e3,
         peak_mem_bytes=peak, launches=launches, want_launches=want,
         shapes={k: list(v.shape) for k, v in out.items()})
    del params, out, prefill_out, vision
    torch.cuda.empty_cache()
    if not finite or not same_first:
        raise AssertionError(f"VLM generate: finite {finite}, the same "
                             f"first token as its prefill {same_first}")
    if launches != want:
        raise AssertionError(f"VLM generate launches {launches}, want {want}")
    emit("vlm_lm_cut", reason="reduced config: an AdamW step of one "
         "full-width group (6.38e9 float32 parameters: weights, gradient, "
         "two moments) needs about 102 GB")
    return launches, phase_lm(ops, VLM_LM_ARGV, phase="vlm_lm")


# ---------------------------------------------------------------------------
# 26. model parallel (--mesh-model): ranks sharing the card through gloo


def _mp_grad_probe():
    """An optimizer that keeps the gradients and the norm the step's
    clipping would use (a model-parallel rank's: the whole tree's), and
    moves no weight."""
    from repro_torch.optim import optimizers
    kept = {}

    def keep(g, state, plist, step, norm_fn=optimizers.global_norm):
        kept["grads"] = list(g)
        kept["norm"] = float(norm_fn(g))
        g.clear()
        return state

    return optimizers.Optimizer(init=lambda p: {}, step=keep), kept


def _mp_f32_check(ops, mesh, cfg, batch, make_step, want, routed):
    """One float32 step of ``cfg`` (full width, depth cut to its
    num_groups) on this rank's mesh against the single-process step on the
    same seed-0 weights and ``batch``, both through the kernel paths: the
    loss and the gradients' global norm within MODEL_TOL, each leaf's
    gradient (this rank's slice against the same slice of the whole one)
    within LM_GRAD_TOL of that slice's largest; the meshed step launches
    exactly ``want``. ``routed``: an MoE arch, whose meshed run takes the
    single-process run's routing (``pinned_routes``)."""
    import gc

    import torch

    from repro_torch.distributed import sharding
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(cfg, dtype="float32", attn_impl="kernel",
                              ssd_impl="kernel")
    routes, flips = [], []
    runs = {}
    for path in ("single", "mesh"):
        params = model_lib.init(cfg, seed=0, device=mesh.device)
        rules = None
        if path == "mesh":
            rules = sharding.MEGATRON_RULES
            model_lib.shard_model(params, cfg, mesh, rules)
        opt, kept = _mp_grad_probe()
        ctx = contextlib.nullcontext()
        if routed:
            ctx = recorded_routes(routes) if path == "single" \
                else pinned_routes(routes, flips)
        ops.reset_stats()
        with ctx:
            _, _, metrics = make_step(cfg, opt, path == "mesh" and mesh,
                                      rules)(params, {}, 0, batch)
        runs[path] = dict(loss=float(metrics["loss"]), norm=kept["norm"],
                          launches=ops.stats())
        runs[path]["grads"] = dict(zip(
            [n for n, _ in params.named_parameters()], kept["grads"]))
        runs[path]["dims"] = model_lib.split_dims(params)
        del params, metrics
        gc.collect()
    worst = dict(rel=0.0, leaf=None)
    single, meshed = runs["single"], runs["mesh"]
    for name, g in meshed["grads"].items():
        w = single["grads"][name]
        dim = meshed["dims"][name]
        if dim is not None:
            n = w.shape[dim] // mesh.model
            w = w.narrow(dim, mesh.model_index * n, n)
        scale = w.abs().max().item()
        diff = (g - w).abs().max().item()
        rel = diff / scale if scale else (0.0 if not diff else math.inf)
        if not math.isfinite(diff) or rel > worst["rel"]:
            worst = dict(rel=rel, leaf=name, abs=diff, scale=scale)
    out = dict(groups=cfg.num_groups, loss=meshed["loss"],
               single_loss=single["loss"], norm=meshed["norm"],
               single_norm=single["norm"], worst_leaf=worst,
               launches=meshed["launches"], want=want,
               flips=sum(f.numel() for f in flips) if routed else None)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mp_check_bars(label, rank, check, grad_tol=LM_GRAD_TOL):
    for a, b in (("loss", "single_loss"), ("norm", "single_norm")):
        if not (math.isfinite(check[a]) and math.isclose(
                check[a], check[b], rel_tol=MODEL_TOL, abs_tol=MODEL_TOL)):
            raise AssertionError(f"{label} rank {rank} float32 step: {a} "
                                 f"{check[a]} against {check[b]}")
    if not check["worst_leaf"]["rel"] <= grad_tol:
        raise AssertionError(f"{label} rank {rank} float32 step: "
                             f"{check['worst_leaf']} beyond {grad_tol}")
    want = {**dict.fromkeys(check["launches"], 0), **check["want"]}
    if check["launches"] != want:
        raise AssertionError(f"{label} rank {rank} float32 step launched "
                             f"{check['launches']}, want {want}")


@contextlib.contextmanager
def depth_cut(train, groups):
    """Inside: ``train``'s builders read every config cut to ``groups``
    groups (full width, depth cut; they look it up through
    ``train.get_config``)."""
    full = train.get_config
    train.get_config = lambda name: dataclasses.replace(full(name),
                                                        num_groups=groups)
    try:
        yield
    finally:
        train.get_config = full


def train_depth(groups):
    """``depth_cut`` of ``train``'s configs to ``groups`` groups; nothing
    where ``groups`` is None."""
    from repro_torch.launch import train
    return (contextlib.nullcontext() if groups is None
            else depth_cut(train, groups))


def _mp_rank(mesh, argv, f32_groups):
    """26a / 26b in each rank: the entry point's builder for this rank
    (``train._BUILDERS``, the mesh's model slices) driven by ``Runtime``
    as ``train._train`` drives it: the per-step losses and step ms, the
    run's launches and peak memory, the model-group all-reduces of its
    steps after the first (of its one step when it runs one: calls,
    bytes, host seconds), and the last
    batch; then the float32 check of the same mode at ``f32_groups``
    groups on that batch. Returns every rank's record on rank 0."""
    import torch

    import repro_torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import learner, sources
    from repro_torch.core.runtime import Runtime
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import common

    repro_torch.resolve_device("cuda")
    args = train._parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    ops.reset_stats()
    t0 = time.perf_counter()
    with depth_cut(train, MP_GROUPS[args.arch]):
        source, step_fn, params, opt_state, extras = train._BUILDERS[
            args.mode](args, mesh)
    extras.pop("checkpoint_layout")
    build_s = time.perf_counter() - t0
    losses, stamps, last = [], [time.perf_counter()], {}
    next_batch = source.next_batch

    def keep_last(params):
        last["batch"] = next_batch(params)
        return last["batch"]

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize(mesh.device)
        stamps.append(time.perf_counter())
        if step == 0 and args.steps > 1:
            common.reset_collective_stats()

    source.next_batch = keep_last
    runtime = Runtime(source, step_fn, params, opt_state,
                      total_steps=args.steps, log_every=0,
                      on_metrics=on_metrics, mesh=mesh, **extras)
    _, lines = _quiet(runtime.run)
    launches = ops.stats()
    collectives = common.collective_stats()
    peak = torch.cuda.max_memory_allocated(mesh.device)
    batch = last["batch"]
    cfg = get_config(args.arch)
    seq = args.seq
    if args.mode == "lm-rl":
        tokens = batch["obs"].cpu()
        loss_cfg = TrainConfig(entropy_cost=0.003)

        def make_step(cfg, opt, mesh, rules):
            return sources.lm_rl_step_from_rollout(learner.make_lm_train_step(
                cfg, opt, loss_cfg, loss_chunk=seq, vtrace_impl="kernel",
                mesh=mesh or None, rules=rules))
        want = {**remat_step_launches(dataclasses.replace(
            cfg, num_groups=f32_groups), seq), "vtrace": 1}
    else:
        tokens = batch["tokens"].cpu()

        def make_step(cfg, opt, mesh, rules):
            return learner.make_lm_pretrain_step(
                cfg, opt, loss_chunk=seq, mesh=mesh or None, rules=rules)
        want = remat_step_launches(dataclasses.replace(
            cfg, num_groups=f32_groups), seq)
    del runtime, source, step_fn, params, opt_state
    torch.cuda.empty_cache()
    check = _mp_f32_check(ops, mesh, dataclasses.replace(
        cfg, num_groups=f32_groups), batch, make_step, want,
        routed=bool(cfg.num_experts))
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    steady = max(1, len(step_ms) - 1)
    return sharding.gather_to_main(dict(
        rank=mesh.rank, model_index=mesh.model_index, losses=losses,
        step_ms=step_ms, build_s=build_s, launches=launches,
        peak_mem_bytes=peak, steady_collectives=collectives,
        allreduce_s_per_step=collectives["seconds"] / steady,
        allreduce_share=collectives["seconds"] / (sum(step_ms[1:]) / 1e3)
        if len(step_ms) > 1 else None,
        tokens=tokens, log=lines, f32=check), mesh)


def phase_mp(argv, f32_groups, phase):
    """26a / 26b: ``argv`` (a --mesh-model 2 run) as two ranks sharing
    cuda:0 through gloo (rank 1 spawned). Every rank must launch exactly
    ``want`` (the unmeshed run's counts: the same layers on half the
    heads), produce finite losses, and pass its float32 check; the ranks'
    losses and last batch's tokens must be bitwise equal. Gloo stages CUDA
    tensors through the host: the times are checks of the collectives,
    not speed figures. Returns each rank's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib

    arch, steps = _arg(argv, "--arch"), int(_arg(argv, "--steps"))
    seq = int(_arg(argv, "--seq"))
    cfg = dataclasses.replace(get_config(arch), num_groups=MP_GROUPS[arch])
    layers, _ = kernel_layers(cfg)
    per_step = remat_step_launches(cfg, seq)
    if _arg(argv, "--mode") == "lm-rl":
        want = {"vtrace": steps, "ssd_chunk": 0,
                "flash_attention": (layers + per_step["flash_attention"])
                * steps,
                "decode_attention": layers * (seq - 1) * steps}
    else:
        want = {"vtrace": 0, "decode_attention": 0,
                **{k: v * steps for k, v in per_step.items()}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_mp_rank, 2, device="cuda", model=2,
                            devices=["cuda:0", "cuda:0"], backend="gloo",
                            args=(argv, f32_groups), timeout_s=300)
    seconds = time.perf_counter() - t0
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"{phase} rank {r['rank']} launched "
                                 f"{r['launches']}, want {want}")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{phase} rank {r['rank']} losses "
                                 f"{r['losses']}")
        _mp_check_bars(phase, r["rank"], r["f32"],
                       XLSTM_GRAD_TOL if arch == XLSTM else LM_GRAD_TOL)
    if ranks[0]["losses"] != ranks[1]["losses"] or not torch.equal(
            ranks[0]["tokens"], ranks[1]["tokens"]):
        raise AssertionError(f"{phase}: the model ranks disagree: losses "
                             f"{ranks[0]['losses']} / {ranks[1]['losses']}"
                             " or their tokens")
    for r in ranks:
        del r["tokens"]
    emit(phase, argv=argv, mesh=[1, 2], backend="gloo", groups=cfg.num_groups,
         published_groups=get_config(arch).num_groups,
         device="cuda:0 (both ranks)", want_launches=want, seconds=seconds,
         timing="gloo's host-staging path, not a speed figure",
         ranks_agree=True, ranks=ranks)
    return [r["launches"] for r in ranks]


def _mp22_rank(mesh, steps_from):
    """26c in each of four ranks: reduced Qwen3-4B float32, both LM
    steps, each of MP22_STEPS batches from the seed-0 weights; the losses
    on rank 0. ``steps_from``: the batches (batch-major, CPU)."""
    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops

    repro_torch.resolve_device("cuda")
    ops.reset_stats()
    out = _mp22_losses(mesh, steps_from)
    out["launches"] = ops.stats()
    return sharding.gather_to_main(out, mesh)


def _mp22_losses(mesh, batches):
    """Each of ``batches``' steps from the seed-0 weights of reduced
    Qwen3-4B (float32, K2 in attention), both LM modes, on this rank of
    ``mesh`` (None: one process); their losses by mode."""
    import torch

    from repro_torch.configs import TrainConfig, get_reduced_config
    from repro_torch.core import learner
    from repro_torch.distributed import sharding
    from repro_torch.models import model as model_lib
    from repro_torch.optim import make_optimizer

    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              attn_impl="kernel")
    device = mesh.device if mesh is not None else torch.device("cuda")
    rules = None if mesh is None else sharding.MEGATRON_RULES
    out = {}
    for mode in ("lm-rl", "lm"):
        tc = TrainConfig(optimizer="adamw", learning_rate=1e-3,
                         grad_clip=1.0, lr_schedule="constant",
                         total_steps=3, entropy_cost=0.003)
        opt = make_optimizer(tc)
        step = learner.make_lm_pretrain_step(cfg, opt, loss_chunk=16,
                                             mesh=mesh, rules=rules) \
            if mode == "lm" else learner.make_lm_train_step(
                cfg, opt, tc, loss_chunk=16, vtrace_impl="kernel",
                mesh=mesh, rules=rules)
        losses = []
        for batch in batches[mode]:
            params = model_lib.init(cfg, seed=0, device=device)
            if mesh is not None:
                model_lib.shard_model(params, cfg, mesh, rules)
            b = {k: v.to(device) for k, v in batch.items()}
            if mesh is not None:
                b = sharding.shard_lm_batch(b, mesh, rules)
            _, _, m = step(params, opt.init(list(params.parameters())), 0, b)
            losses.append(float(m["loss"]))
        out[mode] = losses
    return out


def phase_mp22():
    """26c: reduced Qwen3-4B on a (2, 2) mesh, four ranks sharing cuda:0
    through gloo: each step's loss from the seed-0 weights within MP_TOL
    of the unmeshed step's (mesh (1, 1) is the unmeshed path bitwise:
    tests/test_torch_mesh2d.py), both LM modes, float32: the bar of the
    reference's own (2, 2) test, rtol and atol MP_TOL."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import mesh as mesh_lib

    rng = np.random.default_rng(0)
    vocab = get_reduced_config("qwen3-4b").vocab_size
    batches = {"lm": [], "lm-rl": []}
    for _ in range(MP22_STEPS):
        tokens = torch.from_numpy(rng.integers(0, vocab, (8, 17)))
        batches["lm"].append({"tokens": tokens})
        batches["lm-rl"].append({
            "tokens": tokens,
            "behavior_logprob": torch.full((8, 16), -math.log(vocab)),
            "reward": (tokens[:, 1:] == (5 * tokens[:, :-1] + 3) % vocab
                       ).float(),
            "done": torch.arange(16).expand(8, 16) == 15})
    want = _mp22_losses(None, batches)
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_mp22_rank, 4, device="cuda", model=2,
                            devices=["cuda:0"] * 4, backend="gloo",
                            args=(batches,), timeout_s=300)
    seconds = time.perf_counter() - t0
    # as assert_allclose(rtol=MP_TOL, atol=MP_TOL): the gap over 1 + |loss|
    gaps = {mode: max(abs(a - b) / (1.0 + abs(b)) for r in ranks
                      for a, b in zip(r[mode], want[mode]))
            for mode in want}
    emit("mp22", arch="qwen3-4b (reduced)", mesh=[2, 2], backend="gloo",
         dtype="float32", losses={m: ranks[0][m] for m in want},
         unmeshed=want, gaps=gaps, tol=MP_TOL, seconds=seconds,
         launches=[r["launches"] for r in ranks])
    for mode, gap in gaps.items():
        if not gap <= MP_TOL:
            raise AssertionError(f"26c {mode}: (2, 2) losses {gap} from "
                                 f"the unmeshed steps, beyond {MP_TOL}")


def _elastic_rank(mesh, ckpt_dir, argv, batch):
    """26d's elastic leg in each rank: build the run of ``argv`` on this
    mesh (None: one process), restore ``ckpt_dir``'s latest checkpoint
    through ``--resume``'s path, and return its learner state as whole
    leaves under the checkpoint's keys (the slices gathered over the model
    group, the block leaves stacked) and one step's loss on ``batch``."""
    import torch

    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.models import common
    from repro_torch.models import model as model_lib
    from repro_torch.tree import flatten

    repro_torch.resolve_device("cuda")
    args = train._parser().parse_args(argv + ["--checkpoint-dir", ckpt_dir])
    source, step_fn, params, opt_state, extras = train._BUILDERS[
        args.mode](args, *(() if mesh is None else (mesh,)))
    opt_state, start = train._resume(args, source, params, opt_state,
                                     extras["checkpoint_layout"],
                                     lambda line: None, mesh)
    dims = model_lib.split_dims(params)
    names = [n for n, _ in params.named_parameters()]
    state = {}
    with common.use_rules(mesh, sharding.MEGATRON_RULES):
        for key, v in flatten({"params": params.state_dict(),
                               "opt_state": opt_state}):
            name = key.partition("/")[2] if key.startswith("params/") \
                else names[int(key.rsplit("#", 1)[1])]
            if dims[name] is not None:
                v = common.gather_model_slices(v, dims[name])
            state[key] = v.detach().cpu().clone().numpy()
    state = extras["checkpoint_layout"].to_disk(state)
    b = {k: v.to(params.embed.device) for k, v in batch.items()}
    if mesh is not None:
        b = sharding.shard_lm_batch(b, mesh, sharding.MEGATRON_RULES)
    _, _, m = step_fn(params, opt_state, start, b)
    out = dict(state=state, loss=float(m["loss"]), step=start)
    return out if mesh is None else sharding.gather_to_main(out, mesh)


def _killed_at(cmd, marker, deadline_s=300):
    """Run ``cmd`` in a session of its own and SIGKILL the whole session
    (the spawned ranks too) once ``marker`` exists."""
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                            start_new_session=True, env=_cli_env())
    try:
        deadline = time.monotonic() + deadline_s
        while proc.poll() is None and time.monotonic() < deadline:
            if os.path.exists(marker):
                os.killpg(proc.pid, signal.SIGKILL)
                break
            time.sleep(0.05)
        proc.wait(timeout=60)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    if not os.path.exists(marker):
        raise AssertionError(f"26d: {marker} never landed")


def _cli_env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


# 26d's killed leg: the entry point's parser and rank body (train._train)
# in a process of its own, its second rank spawned onto the same card
# through gloo (train.main would place rank r on cuda:r)
MP_CLI = """
import sys
import repro_torch
from repro_torch.launch import mesh, train
repro_torch.resolve_device("cuda")
args = train._parser().parse_args(sys.argv[1:])
mesh.launch(train._train, 2, device="cuda", model=2, args=(args,),
            devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=300)
"""


def _mp_train(argv):
    """``train._train`` (the entry point's rank body) of ``argv`` on two
    ranks sharing cuda:0 through gloo, rank 0 in this process; its log
    lines."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    args = train._parser().parse_args(argv)
    _, lines = _quiet(lambda: mesh_lib.launch(
        train._train, 2, device="cuda", model=2, args=(args,),
        devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=300))
    return lines


def phase_mp_checkpoint(workdir):
    """26d: reduced --mode lm --mesh-model 2 through the entry point's
    rank body with both ranks on the card: an uninterrupted run; the same
    run in a process of its own (``MP_CLI``) SIGKILLed, with its spawned
    rank (the whole session), once its step-3 checkpoint lands; its
    resume to the same horizon, whose final parameters and AdamW state
    must be bitwise the uninterrupted run's. Then that step-3 checkpoint
    restored elastically at (2, 1) and (1, 1): every leaf bitwise the one
    saved, and the next step's loss on one batch within MP_TOL across the
    two (the same-mesh restore is the resume's)."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.launch import mesh as mesh_lib

    argv = MP_CKPT_ARGV + ["--mesh-model", "2"]
    dir_a, dir_b = os.path.join(workdir, "a"), os.path.join(workdir, "b")
    t0 = time.perf_counter()
    _mp_train(argv + ["--checkpoint-dir", dir_a])
    seconds_a = time.perf_counter() - t0
    _killed_at([sys.executable, "-c", MP_CLI, *argv, "--checkpoint-dir",
                dir_b, "--checkpoint-every", "3"],
               os.path.join(dir_b, "step_3", "manifest.json"))
    for name in os.listdir(dir_b):
        if name.startswith("step_") and int(name[5:]) > 3:
            shutil.rmtree(os.path.join(dir_b, name))
    saved = os.path.join(workdir, "step3")
    shutil.copytree(os.path.join(dir_b, "step_3"),
                    os.path.join(saved, "step_3"))
    t0 = time.perf_counter()
    lines = _mp_train(argv + ["--checkpoint-dir", dir_b, "--resume"])
    seconds_c = time.perf_counter() - t0
    if not any("resumed" in ln and "source state restored" in ln
               for ln in lines):
        raise AssertionError(f"26d: the resume did not restore: {lines}")
    flat_a, _ = ckpt_lib.load_flat(os.path.join(dir_a, "step_6"))
    flat_b, _ = ckpt_lib.load_flat(os.path.join(dir_b, "step_6"))
    if set(flat_a) != set(flat_b) or any(
            not np.array_equal(flat_a[k], flat_b[k]) for k in flat_a):
        raise AssertionError("26d: the resumed run's final state is not "
                             "bitwise the uninterrupted run's")
    # elastic: the (1, 2) step-3 checkpoint on (2, 1) and (1, 1)
    flat3, _ = ckpt_lib.load_flat(os.path.join(saved, "step_3"))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (8, 33)))
    eargv = MP_CKPT_ARGV + ["--device", "cuda"]
    got = {(2, 1): mesh_lib.launch(
        _elastic_rank, 2, device="cuda", model=1,
        devices=["cuda:0", "cuda:0"], backend="gloo",
        args=(saved, eargv + ["--mesh-data", "2"], {"tokens": tokens}),
        timeout_s=300),
        (1, 1): [_elastic_rank(None, saved, eargv, {"tokens": tokens})]}
    for key, ranks in got.items():
        for r in ranks:
            bad = [k for k, v in r["state"].items()
                   if not np.array_equal(v, flat3[k])]
            if bad or set(r["state"]) != set(flat3) or r["step"] != 3:
                raise AssertionError(f"26d: restored at {key}: leaves "
                                     f"{bad[:4]} differ, step {r['step']}")
    base_loss = got[1, 1][0]["loss"]
    losses = {f"{d}x{m}": [r["loss"] for r in ranks]
              for (d, m), ranks in got.items()}
    gaps = {k: max(abs(x - base_loss) / (1.0 + abs(base_loss)) for x in v)
            for k, v in losses.items()}
    emit("mp_checkpoint", argv=argv, killed_after_step=3,
         resumed_bitwise=True, leaves=len(flat3),
         seconds_uninterrupted=seconds_a, seconds_resume=seconds_c,
         elastic_meshes=list(losses), elastic_bitwise=True,
         next_step_losses=losses, gaps=gaps, tol=MP_TOL,
         files=sorted(os.listdir(os.path.join(saved, "step_3"))))
    if not all(g <= MP_TOL for g in gaps.values()):
        raise AssertionError(f"26d: next-step losses {losses} beyond "
                             f"{MP_TOL} of each other")


# ---------------------------------------------------------------------------
# 27. the model axis for the xLSTM mixers and xattn, and the other rules
# tables through launch/specs.py; ranks share the card through gloo


def _rank_slice(whole, layout, mesh):
    """This rank's part of a whole leaf, as ``shard_model`` cuts it:
    ``layout`` (model dimension, data dimension, owning model index)."""
    dim, ddim, owner = layout
    if owner is not None and owner != mesh.model_index:
        return whole.narrow(0, 0, 0)
    for d, parts, index in ((dim, mesh.model, mesh.model_index),
                            (ddim, mesh.data, mesh.data_index)):
        if d is not None and parts > 1:
            n = whole.shape[d] // parts
            whole = whole.narrow(d, index * n, n)
    return whole


def _layouts(params):
    from repro_torch.models import model as model_lib
    dims, ddims = model_lib.split_dims(params), model_lib.data_dims(params)
    owners = {n: None for n in dims}
    for path, node in params.named_modules():
        for name, (owner, _) in getattr(node, "owners", {}).items():
            owners[f"{path}.{name}" if path else name] = owner
    return {n: (dims[n], ddims[n], owners[n]) for n in dims}


def _mp_serve_rank(mesh):
    """27a's server in each rank: xLSTM-125M at full width. Float32: the
    rank's teacher-forced logits (a prefill of each MP_SERVE_LENS prompt,
    then MP_SERVE_STEPS decode steps) against the unmeshed session's in
    the same rank, relative to their largest. Then ``Server(mesh=)`` in
    bf16, MP_SERVE_REQUESTS requests of 1..64 tokens, static batches of
    8: every request served; the ranks' outputs are compared on rank 0."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import use_rules

    repro_torch.resolve_device("cuda")
    rules = sharding.MEGATRON_RULES
    cfg = dataclasses.replace(get_config(XLSTM), num_groups=MP_GROUPS[XLSTM])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, scale = 0.0, 0.0
    ops.reset_stats()
    for prompt_len in MP_SERVE_LENS:
        tokens = torch.randint(0, cfg32.vocab_size,
                               (1, prompt_len + MP_SERVE_STEPS),
                               generator=gen, device="cuda")
        runs = []
        for meshed in (True, False):
            params = model_lib.init(cfg32, seed=0, device="cuda")
            if meshed:
                model_lib.shard_model(params, cfg32, mesh, rules)
            with torch.no_grad(), use_rules(mesh if meshed else None,
                                            rules if meshed else None):
                h, _, cache = model_lib.prefill(
                    params, tokens[:, :prompt_len], cfg=cfg32,
                    cache_seq_len=prompt_len + MP_SERVE_STEPS)
                out = [model_lib.logits_from_hidden(params, cfg32,
                                                    h[:, -1:])]
                for t in range(prompt_len, prompt_len + MP_SERVE_STEPS - 1):
                    lg, _, cache = model_lib.serve_step(
                        params, tokens[:, t:t + 1], cache, t, cfg=cfg32)
                    out.append(lg)
            runs.append(torch.cat(out, dim=1))
            del params, cache
        worst = max(worst, (runs[0] - runs[1]).abs().max().item())
        scale = max(scale, runs[1].abs().max().item())
    params = model_lib.shard_model(model_lib.init(cfg, seed=0,
                                                  device="cuda"),
                                   cfg, mesh, rules)
    rng = np.random.default_rng(3)
    server = serve.Server(cfg, params, max_batch=8, max_len=128,
                          policy="static", mesh=mesh, rules=rules)
    handles = [server.submit(rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(1, 65))),
                             max_tokens=MP_SERVE_TOKENS, seed=i)
               for i in range(MP_SERVE_REQUESTS)]
    t0 = time.perf_counter()
    server.start()
    results = [h.result(timeout=600) for h in handles]
    server.stop()
    seconds = time.perf_counter() - t0
    return sharding.gather_to_main(dict(
        rank=mesh.rank, f32_max_abs_logit_diff=worst, logit_scale=scale,
        served=server.served, steps=server.steps,
        admissions=server.admissions, seconds=seconds,
        decode_ms_per_step=server.decode_seconds / max(1, server.steps)
        * 1e3, launches=ops.stats(), compiled=server.session.compiled,
        outputs=[r.tolist() for r in results]), mesh)


def phase_mp_serve():
    """27a's server: ``_mp_serve_rank`` in two ranks sharing cuda:0."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_mp_serve_rank, 2, device="cuda", model=2,
                            devices=["cuda:0", "cuda:0"], backend="gloo",
                            timeout_s=300)
    for r in ranks:
        rel = r["f32_max_abs_logit_diff"] / max(1.0, r["logit_scale"])
        r["f32_rel_logit_diff"] = rel
        if not rel <= MP_SERVE_RTOL:
            raise AssertionError(f"mp_serve rank {r['rank']}: float32 "
                                 f"logits {rel:.3e} of their largest from "
                                 f"the unmeshed session's")
        if r["served"] != MP_SERVE_REQUESTS or any(r["launches"].values()) \
                or r["compiled"]:
            raise AssertionError(f"mp_serve rank {r['rank']} served "
                                 f"{r['served']} of {MP_SERVE_REQUESTS}, "
                                 f"launched {r['launches']}, compiled "
                                 f"{r['compiled']} (a meshed session is "
                                 "eager by rule)")
    if ranks[0]["outputs"] != ranks[1]["outputs"]:
        raise AssertionError("mp_serve: the model ranks' outputs differ")
    for r in ranks:
        del r["outputs"]
    emit("mp_xlstm_serve", arch=XLSTM, mesh=[1, 2], backend="gloo",
         prompt_lens=list(MP_SERVE_LENS), teacher_forced_steps=MP_SERVE_STEPS,
         rel_tol=MP_SERVE_RTOL, seconds=time.perf_counter() - t0,
         timing="gloo's host-staging path, not a speed figure", ranks=ranks)


def _mp_vlm_rank(mesh):
    """27b in each rank: one of Llama-3.2-Vision-90B's 20 groups at every
    published width, split over two ranks (each builds the whole group in
    turn, keeps its slices and frees the rest). Float32: the kernel path
    against the plain path on B 2 x VLM_PROMPT tokens with the vision stub
    (the logits within MODEL_TOL of their largest). bf16:
    ``generate(vision=)`` at B 4, VLM_PROMPT + MP_VLM_GEN tokens. Returns
    the launches of each part, the per-rank K2/K3 head counts, peak memory
    and times, on rank 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import use_rules

    repro_torch.resolve_device("cuda")
    rules = sharding.MEGATRON_RULES
    cfg = dataclasses.replace(get_config(VLM), num_groups=VLM_GROUPS,
                              dtype="float32")
    params = None
    for r in range(mesh.size):
        if mesh.rank == r:
            params = model_lib.shard_model(
                model_lib.init(cfg, seed=0, device="cuda"), cfg, mesh, rules)
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, VLM_PROMPT),
                           generator=gen, device="cuda")
    vision = vision_stub(cfg, 2, torch.float32)
    logits = {}
    ops.reset_stats()
    with torch.no_grad(), use_rules(mesh, rules):
        heads = (cfg.num_heads // attention.head_split(cfg),
                 cfg.num_kv_heads // attention.head_split(cfg))
        for impl in ("kernel", "xla_chunked"):
            logits[impl], _, _ = model_lib.apply_lm(
                params, tokens, cfg=cfg, vision=vision, impl=impl)
    f32_launches = ops.stats()
    diff = (logits["kernel"] - logits["xla_chunked"]).abs().max().item()
    scale = logits["xla_chunked"].abs().max().item()
    del logits
    bcfg = dataclasses.replace(cfg, dtype="bfloat16", attn_impl="kernel")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (4, VLM_PROMPT))
    ops.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gen_lib.generate(params, prompt, 0, cfg=bcfg,
                           num_steps=MP_VLM_GEN,
                           vision=vision_stub(bcfg, 4, torch.bfloat16),
                           mesh=mesh, rules=rules)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return sharding.gather_to_main(dict(
        rank=mesh.rank, heads_per_rank=list(heads),
        f32_max_abs_diff=diff, f32_logit_scale=scale,
        f32_launches=f32_launches, generate_launches=ops.stats(),
        generate_seconds=seconds,
        tokens_finite=bool(torch.isfinite(out["logprob"]).all()),
        tokens=out["tokens"].cpu(),
        peak_mem_bytes=torch.cuda.max_memory_allocated()), mesh)


def phase_mp_vlm():
    """27b: ``_mp_vlm_rank`` in two ranks sharing cuda:0 through gloo. K2
    once a self-attention layer in each float32 kernel forward and in the
    prefill, K3 once such a layer a decode step; the ranks' tokens equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib

    cfg = dataclasses.replace(get_config(VLM), num_groups=VLM_GROUPS)
    attn, _ = kernel_layers(cfg)
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_mp_vlm_rank, 2, device="cuda", model=2,
                            devices=["cuda:0", "cuda:0"], backend="gloo",
                            timeout_s=600)
    want_f32 = {"vtrace": 0, "flash_attention": attn, "decode_attention": 0,
                "ssd_chunk": 0}
    want_gen = {"vtrace": 0, "flash_attention": attn,
                "decode_attention": attn * (MP_VLM_GEN - 1), "ssd_chunk": 0}
    for r in ranks:
        rel = r["f32_max_abs_diff"] / max(1.0, r["f32_logit_scale"])
        r["f32_rel_diff"] = rel
        if not rel <= MODEL_TOL:
            raise AssertionError(f"mp_vlm rank {r['rank']} float32 kernel "
                                 f"vs plain {rel:.3e} > {MODEL_TOL}")
        if r["f32_launches"] != want_f32 or r["generate_launches"] \
                != want_gen:
            raise AssertionError(f"mp_vlm rank {r['rank']} launched "
                                 f"{r['f32_launches']} / "
                                 f"{r['generate_launches']}, want "
                                 f"{want_f32} / {want_gen}")
        if r["heads_per_rank"] != [cfg.num_heads // 2,
                                   cfg.num_kv_heads // 2]:
            raise AssertionError(f"mp_vlm heads {r['heads_per_rank']}")
        if not r["tokens_finite"]:
            raise AssertionError("mp_vlm generate: logprobs not finite")
    if not torch.equal(ranks[0]["tokens"], ranks[1]["tokens"]):
        raise AssertionError("mp_vlm: the model ranks' tokens differ")
    for r in ranks:
        del r["tokens"]
    emit("mp_vlm", arch=VLM, groups=VLM_GROUPS, mesh=[1, 2],
         backend="gloo", prompt=VLM_PROMPT, generated=MP_VLM_GEN,
         want_f32=want_f32, want_generate=want_gen,
         seconds=time.perf_counter() - t0,
         timing="gloo's host-staging path, not a speed figure", ranks=ranks)
    return ranks[0]["generate_launches"]


def _spec_cfg(run):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(run["arch"]), dtype="float32")
    if run.get("groups"):
        cfg = dataclasses.replace(cfg, num_groups=run["groups"])
    return cfg


def _spec_rules(run, mesh):
    from repro_torch.distributed import sharding
    return sharding.rules_named(run["rules"]) if mesh.size > 1 \
        else sharding.MEGATRON_RULES


@contextlib.contextmanager
def captured_grads(kept):
    """Inside: the optimizer ``launch/specs.py::build_train`` wraps in
    ``zero1`` hands ``kept`` the gradients each step gives it (ZeRO-2's
    slices) and their global norm (the whole tree's), on the host, before
    it updates: the float32 check reads the program's own step."""
    from repro_torch.launch import specs
    from repro_torch.optim import optimizers
    real = specs.zero1

    def capturing(opt, slices, mesh):
        inner = real(opt, slices, mesh)

        def step(grads, state, params, step, norm_fn=optimizers.global_norm):
            kept["grads"] = [g.detach().to("cpu", copy=True) for g in grads]
            kept["norm"] = float(norm_fn(grads))
            return inner.step(grads, state, params, step, norm_fn=norm_fn)
        return optimizers.Optimizer(inner.init, step)

    specs.zero1 = capturing
    try:
        yield kept
    finally:
        specs.zero1 = real


def _spec_rules(run, mesh):
    from repro_torch.distributed import sharding
    return sharding.rules_named(run["rules"]) if mesh.size > 1 \
        else sharding.MEGATRON_RULES


def _spec_program(run, mesh, kept):
    """The run's program for ``mesh``, on the model's own seed-0 weights
    (``model.init``; the programs' own 0.01 * normal draws leave some
    leaves' float32 gradients at the rounding floor, e.g. attention's
    ``wk`` with near-zero scores: multihost (27d) runs on those); a train
    program's optimizer hands its gradients to ``kept``."""
    from repro_torch.configs.base import ImplContext
    from repro_torch.launch import specs
    from repro_torch.models import model as model_lib

    kw = {"vtrace_impl": "kernel"} if run["shape"].kind == "train" else {}
    cfg = _spec_cfg(run)
    with captured_grads(kept):
        return specs.build_program(
            run["arch"], run["shape"], mesh, _spec_rules(run, mesh),
            base_cfg=cfg, impls=ImplContext(attn="kernel", ssd="kernel"),
            params=model_lib.init(cfg, seed=0, device=mesh.device), **kw)


def _spec_inputs(run, cfg, mesh):
    """The runs' inputs, alike in the meshed and single-rank programs:
    seeded random tokens (the programs' own are zeros, under which every
    position's key and value are equal and attention's ``wq`` / ``wk``
    gradients vanish) and the reference test's episodes, this rank's
    rows."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding

    rng = np.random.default_rng(0)
    shape = run["shape"]
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = rng.integers(0, cfg.vocab_size, (b, s + 1))
        done = np.zeros((b, s), bool)
        done[:, -1] = True
        out = {"tokens": tokens.astype(np.int32),
               "behavior_logprob": np.full((b, s), -np.log(cfg.vocab_size),
                                           np.float32),
               "reward": (tokens[:, 1:] == (5 * tokens[:, :-1] + 3)
                          % cfg.vocab_size).astype(np.float32),
               "done": done}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (b, run["steps"])).astype(np.int32)}
    out = {k: torch.as_tensor(v, device=mesh.device) for k, v in out.items()}
    return sharding.shard_lm_batch(out, mesh, _spec_rules(run, mesh))


def _spec_first(run, mesh, fn, args, cfg, kept, routes):
    """The program's first step, which the float32 check reads, under the
    MoE routing context ``routes``; a decode program starts from a zero
    cache. Returns (the loss and gradients' norm, or the logits, on the
    host; the state to go on from: a train step's gradients by name on
    the host, or (params, tokens, cache))."""
    import torch

    from repro_torch.models.common import tree_map

    if run["shape"].kind == "train":
        params, opt_state = args[:2]
        with routes:
            _, _, m = fn(params, opt_state, 0, _spec_inputs(run, cfg, mesh))
        names = [n for n, _ in params.named_parameters()]
        return (dict(loss=float(m["loss"]), norm=kept["norm"]),
                dict(zip(names, kept["grads"])))
    params, _, cache, _ = args
    tokens = _spec_inputs(run, cfg, mesh)["tokens"]
    cache = tree_map(torch.zeros_like, cache)
    with routes:
        logits, _, cache = fn(params, tokens[:, :1], cache, 0)
    return dict(logits=logits.cpu()), (params, tokens, cache)


def _spec_rank(mesh, run):
    """27c in each rank: the ``specs`` program ``run`` built for this rank
    (the ranks build one after another: each draws the whole tree, keeps
    its slices and frees the rest), then ``run["steps"]`` timed steps, the
    first of which the float32 check reads (``_spec_first``): per-step
    ms, launches, peak memory, the collectives by group and kind, the
    ZeRO-1 state held. Then each rank in turn runs the same program on one
    rank (a (1, 1) mesh without collectives), with the meshed run's MoE
    routing pinned, and holds its own slices to it (``_spec_check``).
    Returns every rank's record on rank 0."""
    import gc

    import torch
    import torch.distributed as dist

    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common

    repro_torch.resolve_device("cuda")
    train = run["shape"].kind == "train"
    kept = {}
    fn = args = None
    t0 = time.perf_counter()
    for r in range(mesh.size):
        if mesh.rank == r:
            fn, args, cfg, extras = _spec_program(run, mesh, kept)
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    build_s = time.perf_counter() - t0
    layouts = _layouts(args[0])
    zero = extras.get("zero")
    zero_held = sum(x.numel() for v in args[1].values() for x in v) \
        if train else None
    torch.cuda.reset_peak_memory_stats()
    ops.reset_stats()
    common.reset_collective_stats()
    routed = []
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    first, state = _spec_first(run, mesh, fn, args, cfg, kept,
                               recorded_routes(routed))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    grads = state if train else None
    params = args[0]
    for step in range(1, run["steps"]):
        if train:
            _, _, m = fn(params, args[1], step, _spec_inputs(run, cfg, mesh))
        else:
            _, tokens, cache = state
            _, _, cache = fn(params, tokens[:, step:step + 1], cache, step)
            state = (params, tokens, cache)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    launches = ops.stats()
    collectives = common.collective_stats()
    peak = torch.cuda.max_memory_allocated()
    del fn, args, state, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)
    check = None
    for r in range(mesh.size):
        if mesh.rank == r:
            check = _spec_check(run, mesh, mesh_lib, layouts, zero, first,
                                grads, routed)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.group)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return sharding.gather_to_main(dict(
        rank=mesh.rank, data_index=mesh.data_index,
        model_index=mesh.model_index, build_s=build_s,
        loss=first.get("loss"), step_ms=step_ms, launches=launches,
        peak_mem_bytes=peak, zero_state_elements=zero_held,
        collectives=collectives,
        collective_s_per_step=collectives["seconds"] / len(step_ms),
        check=check), mesh)


def _spec_check(run, mesh, mesh_lib, layouts, zero, first, grads, routed):
    """The single-rank program against this rank's record: the loss and
    global norm within MODEL_TOL and each leaf's gradient (this rank's
    slice, and ZeRO-2's slice of it) within LM_GRAD_TOL of that slice's
    largest (train), or the logits of this rank's rows within MODEL_TOL
    of their largest (decode)."""
    from repro_torch.optim.optimizers import zero_view

    single = mesh_lib.Mesh2D(0, 1, 1, mesh.device, "gloo")
    kept = {}
    fn, args, cfg, _ = _spec_program(run, single, kept)
    flips = []
    got, whole = _spec_first(run, single, fn, args, cfg, kept,
                             pinned_routes(routed, flips) if routed
                             else contextlib.nullcontext())
    out = dict(flips=sum(f.numel() for f in flips))
    if run["shape"].kind == "train":
        out.update(loss=first["loss"], single_loss=got["loss"],
                   norm=first["norm"], single_norm=got["norm"])
        worst = dict(rel=0.0, leaf=None)
        names = [n for n, _ in args[0].named_parameters()]
        for name, z in zip(names, zero or [None] * len(names)):
            want = zero_view(_rank_slice(whole[name], layouts[name], mesh),
                             z)
            if not want.numel():
                continue
            diff = (grads[name] - want).abs().max().item()
            scale = want.abs().max().item()
            rel = diff / scale if scale else (0.0 if not diff else math.inf)
            if not math.isfinite(diff) or rel > worst["rel"]:
                worst = dict(rel=rel, leaf=name, abs=diff, scale=scale)
        out["worst_leaf"] = worst
    else:
        rows = got["logits"].shape[0] // mesh.data \
            if got["logits"].shape[0] % mesh.data == 0 else None
        want = got["logits"] if rows is None else got["logits"][
            mesh.data_index * rows:(mesh.data_index + 1) * rows]
        out.update(max_abs_logit_diff=(first["logits"] - want).abs()
                   .max().item(), logit_scale=want.abs().max().item())
    return out


def phase_specs(run):
    """27c: one ``specs`` program ``run`` on its mesh, ranks sharing
    cuda:0 through gloo; the launches a rank against the prediction from
    the layer count, the float32 bars of ``_spec_rank``."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs

    data, model = run["mesh"]
    cfg = specs.resolve_config(run["arch"], run["shape"], _spec_cfg(run))
    attn, _ = kernel_layers(cfg)
    steps, seq = run["steps"], run["shape"].seq_len
    if run["shape"].kind == "train":
        per = remat_step_launches(cfg, seq)
        want = {"vtrace": steps, "decode_attention": 0,
                **{k: v * steps for k, v in per.items()}}
    else:
        want = {"vtrace": 0, "flash_attention": 0, "ssd_chunk": 0,
                "decode_attention": attn * steps}
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(_spec_rank, data * model, device="cuda",
                            model=model,
                            devices=["cuda:0"] * (data * model),
                            backend="gloo", args=(run,), timeout_s=900)
    for r in ranks:
        c = r["check"]
        if r["launches"] != want:
            raise AssertionError(f"{run['phase']} rank {r['rank']} launched "
                                 f"{r['launches']}, want {want}")
        if run["shape"].kind == "train":
            if not math.isfinite(r["loss"]):
                raise AssertionError(f"{run['phase']} loss {r['loss']}")
            _mp_check_bars(run["phase"], r["rank"],
                           dict(c, launches={}, want={}))
        elif not c["max_abs_logit_diff"] <= MODEL_TOL * max(
                1.0, c["logit_scale"]):
            raise AssertionError(f"{run['phase']} rank {r['rank']} logits "
                                 f"{c['max_abs_logit_diff']:.3e} apart")
    shape = run["shape"]
    emit(run["phase"], arch=run["arch"], rules=run["rules"],
         groups=cfg.num_groups, mesh=[data, model], backend="gloo",
         dtype="float32", shape=dict(name=shape.name, seq=shape.seq_len,
                                     batch=shape.global_batch,
                                     kind=shape.kind),
         reduced_from=run["reduced_from"], steps=steps, want_launches=want,
         bytes_reckoned=run["bytes"], seconds=time.perf_counter() - t0,
         timing="gloo's host-staging path, not a speed figure", ranks=ranks)
    return ranks[0]["launches"]


def phase27():
    """27a–d; returns each run's launches a rank, by phase."""
    from repro_torch.configs.base import InputShape

    out = {"mp_xlstm_lm_rl": phase_mp(XMP_RL_ARGV, XMP_F32_GROUPS,
                                      "mp_xlstm_lm_rl")[0],
           "mp_xlstm_lm": phase_mp(XMP_LM_ARGV, XMP_F32_GROUPS,
                                   "mp_xlstm_lm")[0]}
    phase_mp_serve()
    out["mp_vlm"] = phase_mp_vlm()
    for run in SPEC_RUNS:
        out[run["phase"]] = phase_specs(
            dict(run, shape=InputShape(*run["shape"])))
    phase_multihost_serve()
    return out


def phase_multihost_serve():
    """27d: ``python -m repro_torch.launch.multihost --mode serve`` as two
    ``--coordinator`` processes on the card (``--backend gloo``: they
    share it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.multihost"] + MH_ARGV
        + ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--process-id", str(i), "--backend", "gloo"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_cli_env())
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    seconds = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"[host {i}] serve steps OK" not in out:
            raise AssertionError(f"multihost process {i} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    emit("multihost_serve", argv=MH_ARGV, processes=2, seconds=seconds,
         output=[o.strip().splitlines() for o in outs])


# ---------------------------------------------------------------------------
# slice 15: K2's query offset, the geometry mirrors, rl-agent over
# coordinated processes, the context-parallel program, the dry run


def phase_flash_offset(ops, ref):
    """Phase 3's K2 rows with the queries offset from the keys
    (``q_offset``): each FLASH_OFFSET_SHAPES entry in bf16 and float32
    against its plain version at the attention bars, timed beside its
    bound and SDPA with the explicit causal mask of those positions.
    Returns {(shape, dtype name): row}."""
    import torch
    import torch.nn.functional as F
    rows = {}
    for i, shape in enumerate(FLASH_OFFSET_SHAPES):
        b, h, kh, sq, sk, off, hd = shape
        gen = torch.Generator(device="cuda").manual_seed(2500 + i)
        q32 = torch.randn((b, h, sq, hd), generator=gen, device="cuda")
        k32 = torch.randn((b, kh, sk, hd), generator=gen, device="cuda")
        v32 = torch.randn((b, kh, sk, hd), generator=gen, device="cuda")
        qpos = off + torch.arange(sq, device="cuda")
        mask = torch.arange(sk, device="cuda")[None, :] <= qpos[:, None]
        pairs = int(mask.sum())
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            got = ops.flash_attention(q, k, v, q_offset=off)
            want = ref.ref_flash_attention(q.float(), k.float(), v.float(),
                                           q_offset=off)
            torch.cuda.synchronize()
            err = _compare(got, want, dtype)
            del got, want

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            name = str(dtype).split(".")[1]
            row = _time_row(
                lambda: ops.flash_attention(q, k, v, q_offset=off),
                lambda: ref.ref_flash_attention(q, k, v, q_offset=off),
                library, 2 * (q.numel() + k.numel()) * q.element_size(),
                4 * hd * h * b * pairs, dtype, 50)
            row["roofline_ms"], row["roofline_bound"] = _roofline_ms(
                "flash_attention", dtype_bytes=q.element_size(), dtype=name,
                b=b, h=h, kh=kh, s=sk, hd=hd, sq=sq, q_offset=off)
            row.update(max_abs_err=err, dtype=name, shape=[b, h, kh, sq, hd],
                       keys=sk, q_offset=off, pairs=pairs,
                       library_note="SDPA with the boolean mask of these "
                                    "positions")
            rows[(shape, name)] = row
            emit("kernel", name="flash_attention_offset", **row)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_geometry(ops):
    """2b: each kernel's Python launch geometry (``ops.launch_geometry``,
    which ``python -m repro_torch.analysis`` audits) against the built
    ``.cu``'s own ``<kernel>_geometry`` at phase 3's shapes and at every
    launch the audit checks (every arch x input shape)."""
    import torch

    from repro_torch.analysis.kernel_audit import audit_kernels

    sms = ops._sm_count(torch.device("cuda", 0))
    cases = [("vtrace", dict(t=t, b=b)) for t, b in
             VTRACE_SHAPES + REPLAY_VTRACE_SHAPES + LM_RL_VTRACE_SHAPES]
    for bf16 in (True, False):
        cases += [("flash_attention", dict(b=b, h=h, sq=s, hd=hd, bf16=bf16))
                  for b, h, _, s, hd, _, _ in FLASH_SHAPES]
        cases += [("flash_attention", dict(b=b, h=h, sq=sq, hd=hd,
                                           bf16=bf16))
                  for b, h, _, sq, _, _, hd in FLASH_OFFSET_SHAPES]
        cases += [("decode_attention", dict(b=b, h=h, kh=kh, s=cap, hd=hd,
                                            bf16=bf16, sms=sms))
                  for b, h, kh, cap, hd, _, _, _ in DECODE_SHAPES]
    cases += [("ssd_chunk", dict(rows=sl, l=length, n=n, p=p))
              for sl, length, n, p, _, _ in SSD_SHAPES]
    _, tables = audit_kernels()
    cases += [(t["kernel"], t["dims"]) for t in tables]
    bad = []
    for kernel, dims in cases:
        mirror = [(tuple(g), t, m) for g, t, m in
                  ops.launch_geometry(kernel, **dims)]
        built = ops.library_geometry(kernel, **dims)
        if mirror != built:
            bad.append(dict(kernel=kernel, dims=dims, mirror=mirror,
                            built=built))
    smem = [(length, n, p, ops.ssd_smem_bytes(length, n, p),
             ops.ssd_chunk_smem_bytes(length, n, p))
            for _, length, n, p, _, _ in SSD_SHAPES]
    bad += [dict(kernel="ssd_smem", dims=x[:3], mirror=x[3], built=x[4])
            for x in smem if x[3] != x[4]]
    emit("geometry", cases=len(cases), audited=len(tables),
         mismatches=bad)
    if bad:
        raise AssertionError(f"geometry mirrors differ from the .cu: {bad}")


def _mh_rl_rank(mesh, argv):
    """28a's spawned leg in each rank: ``train._train`` (train.main's rank
    body) on the parsed command, cuDNN pinned deterministic; returns each
    rank's launches, final loss and log on rank 0."""
    import repro_torch
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    repro_torch.resolve_device("cuda")
    args = train._parser().parse_args(argv)
    with cudnn_deterministic():
        ops.reset_stats()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            runtime = train._train(mesh, args)
        launches = ops.stats()["vtrace"]
    return sharding.gather_to_main(dict(
        launches=launches, loss=float(runtime.metrics["loss"]),
        log=out.getvalue()), mesh)


# 28a's coordinated leg: one process a rank, train.main as a user runs it
MH_RL_CLI = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import repro_torch
from repro_torch.kernels import ops
from repro_torch.launch import train
repro_torch.resolve_device("cuda")
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
ops.reset_stats()
runtime = train.main(sys.argv[2:])
print("MH_RL " + json.dumps(dict(launches=ops.stats()["vtrace"],
                                 loss=float(runtime.metrics["loss"]))),
      flush=True)
"""


def _step_lines(text):
    return [ln.split(" fps=")[0] for ln in text.splitlines()
            if ln.startswith("step")]


def phase_mh_rl(workdir):
    """28a: ``train.main --mode rl-agent --mesh-data 2 --coordinator
    ...`` as two processes sharing cuda:0 through gloo (one rank a
    process, ``multihost.bootstrap``'s DataMesh) against the same command's
    two ranks spawned onto the card (``launch(devices=, backend=
    "gloo")``, as 17b spawns its ranks): the step lines and final loss
    bitwise, the final checkpoint bitwise, and each coordinated process's
    K1 launches equal to its steps. Returns those launches."""
    import socket

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.launch import mesh as mesh_lib

    one, two = (os.path.join(workdir, d) for d in ("spawned", "coord"))
    t0 = time.perf_counter()
    spawned = mesh_lib.launch(
        _mh_rl_rank, 2, device="cuda", devices=["cuda:0", "cuda:0"],
        backend="gloo", args=(MH_RL_ARGV + ["--checkpoint-dir", one],),
        timeout_s=300)
    spawned_s = time.perf_counter() - t0
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_RL_CLI, SRC] + MH_RL_ARGV
        + ["--checkpoint-dir", two, "--coordinator", f"127.0.0.1:{port}",
           "--num-processes", "2", "--process-id", str(i),
           "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_cli_env()) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    coord_s = time.perf_counter() - t0
    records = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        said = [ln for ln in out.splitlines() if ln.startswith("MH_RL ")]
        if p.returncode != 0 or not said:
            raise AssertionError(f"28a process {i} exited {p.returncode}:"
                                 f"\n{out[-3000:]}")
        records.append(json.loads(said[-1][len("MH_RL "):]))
    launches = [r["launches"] for r in records]
    if launches != [MH_RL_STEPS] * 2:
        raise AssertionError(f"28a: K1 launches {launches} in "
                             f"{MH_RL_STEPS} steps a process")
    if _step_lines(outs[0]) != _step_lines(spawned[0]["log"]) \
            or len(_step_lines(outs[0])) != MH_RL_STEPS:
        raise AssertionError(f"28a: step lines differ:\n{outs[0]}\n"
                             f"{spawned[0]['log']}")
    if records[0]["loss"] != spawned[0]["loss"]:
        raise AssertionError(f"28a: final loss {records[0]['loss']!r}, "
                             f"spawned {spawned[0]['loss']!r}")
    import torch
    step = f"step_{MH_RL_STEPS}"
    got, want = ({k: torch.as_tensor(v) for k, v in sorted(
        ckpt_lib.load_flat(os.path.join(d, step))[0].items())}
        for d in (two, one))
    _bitwise("28a: the coordinated run's checkpoint", got, want)
    emit("mh_rl", argv=MH_RL_ARGV, processes=2, backend="gloo",
         device="cuda:0 (both processes)", steps=MH_RL_STEPS,
         shape=list(MH_RL_SHAPE), launches=launches,
         spawned_launches=[r["launches"] for r in spawned],
         loss=records[0]["loss"], bitwise=True,
         step_lines=_step_lines(outs[0]), spawned_s=spawned_s,
         coordinated_s=coord_s,
         timing="gloo's host-staging path, not a speed figure")
    return launches


def phase_dryrun():
    """28c: ``python -m repro_torch.launch.dryrun`` on the card: one
    step of xLSTM-125M's decode_32k program and of its block program,
    peak memory measured; then the modelled report of the production
    mesh."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        (run,) = dryrun.main(DRYRUN_ARGV + ["--device", "cuda"])
        (modelled,) = dryrun.main(DRYRUN_ARGV[:4] + ["--mesh", "16x16"])
    if not run["memory"]["peak_bytes"] or run["sources"][
            "memory.peak_bytes"] != "measured":
        raise AssertionError(f"28c: no peak memory measured: {run}")
    emit("dryrun", argv=DRYRUN_ARGV, seconds=time.perf_counter() - t0,
         output=out.getvalue().strip().splitlines(),
         memory=run["memory"], step_s=run["step_s"],
         launches=run["launches"], block=run["cost_block"],
         roofline=run["roofline"], modelled_16x16=dict(
             memory=modelled["memory"], roofline=modelled["roofline"]))


def phase28():
    """28a–c; returns each run's launches a rank, by phase."""
    from repro_torch.configs.base import InputShape
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as workdir:
        out = {"mh_rl": {"vtrace": phase_mh_rl(workdir)}}
    out[CP_SPEC_RUN["phase"]] = phase_specs(
        dict(CP_SPEC_RUN, shape=InputShape(*CP_SPEC_RUN["shape"])))
    phase_dryrun()
    return out


# ---------------------------------------------------------------------------
# 29. the compiled decode step (session_fns): CUDA graphs against eager


def _clone_state(state):
    """A copy of a session state that shares nothing with it: tensors
    cloned, each generator at the same place of its stream."""
    import torch

    from repro_torch.models.common import tree_map

    def gen(g):
        out = torch.Generator(device=g.device)
        out.set_state(g.get_state())
        return out
    return {"cache": tree_map(torch.clone, state["cache"]),
            "pos": state["pos"].clone(), "last": state["last"].clone(),
            "temp": state["temp"].clone(),
            "gens": [gen(g) for g in state["gens"]],
            "active": state["active"].copy()}


def _gap(got, want):
    """0.0 when bitwise equal, else the largest absolute difference (inf
    for another shape or dtype)."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        return math.inf
    if got.dtype.is_floating_point:
        if torch.equal(got.reshape(-1).view(torch.uint8),
                       want.reshape(-1).view(torch.uint8)):
            return 0.0
        return float((got.double() - want.double()).abs().max())
    return 0.0 if torch.equal(got, want) else float(
        (got.long() - want.long()).abs().max())


def graph_against_eager(ops, fns, params, state, ref, cfg, steps, gaps):
    """``steps`` decode steps of ``state`` through ``fns`` (its first call
    for a key warms eagerly, the second captures, the rest replay)
    against eager steps of ``ref`` (``_session_step``'s halves): logits,
    baseline, every cache leaf, then the sampled token, log-prob, entropy
    and the step's baseline, each product's worst gap into ``gaps``;
    decode-attention launches of each graph step equal to the eager
    step's. Returns the graph steps' K3 launches."""
    from repro_torch.core import generate as gen_lib
    from repro_torch.tree import flatten

    def note(name, got, want):
        gaps[name] = max(gaps.get(name, 0.0), _gap(got, want))

    total = 0
    for _ in range(steps):
        before = ops.stats()["decode_attention"]
        lg, bg = fns.decode(params, state)
        lg = lg.clone()
        k3 = ops.stats()["decode_attention"] - before
        le, be = gen_lib._session_decode(params, ref, cfg=cfg)
        k3_eager = ops.stats()["decode_attention"] - before - k3
        if k3 != k3_eager:
            raise AssertionError(f"graph step K3 {k3}, eager {k3_eager}")
        total += k3
        note("logits", lg, le)
        if bg is not None:
            note("baseline_head", bg, be)
        for (path, x), (_, y) in zip(flatten(state["cache"]),
                                     flatten(ref["cache"])):
            note("cache/" + path, x, y)
        _, og = gen_lib._session_advance(state, lg, bg)
        _, oe = gen_lib._session_advance(ref, le, be)
        for k in og:
            note(k, og[k], oe[k])
        note("pos", state["pos"], ref["pos"])
    return total


def _check_bitwise(phase, gaps):
    bad = {k: v for k, v in gaps.items() if v != 0.0}
    if bad:
        raise AssertionError(f"{phase}: the graph path is not bitwise the "
                             f"eager path: {bad}")


def _sgd_in_place(params, seed):
    """One in-place SGD step (lr 1e-3, no clip) of the port's optimizer on
    seeded random gradients, one leaf at a time."""
    import torch

    from repro_torch.optim import sgd
    opt = sgd(1e-3)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            g = torch.randn(p.shape, generator=gen, device=p.device)
            opt.step([g], opt.init([p]), [p], 0)


def _alternated_ms(fns_by_name, steps, rounds=2):
    """Host ms a call of each function (synchronised), in turns: median
    over ``rounds`` blocks of ``steps`` calls each."""
    import torch
    times = {name: [] for name in fns_by_name}
    for _ in range(rounds):
        for name, fn in fns_by_name.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / steps * 1e3)
    return {name: statistics.median(v) for name, v in times.items()}


def phase_graph_session(ops, arch, prompt_lens, cap, swap=False,
                        groups=None):
    """29 for one server's session at full width (bf16 on float32
    weights from seed 0; ``groups`` of its groups, where given; 8 slots
    admitted with ``prompt_lens`` into
    ``cap``-slot caches, slot 7 then evicted): GRAPH_CHECK_STEPS steps of
    the compiled step against eager from the same state, bitwise; one
    capture; an in-place SGD step of the weights, then GRAPH_AFTER_STEPS
    more steps held the same way with no new capture; with ``swap``,
    another params module: one more capture and its steps bitwise too.
    Then decode ms a step, eager and graph in turns (DecodeSession.step
    and ``_session_step``, each with its host copy), the device time of
    one replay (CUDA events) and a profile of GRAPH_PROFILED graph steps
    (device busy share)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(
        get_config(arch), attn_impl="kernel", ssd_impl="kernel",
        num_groups=groups or get_config(arch).num_groups)
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = gen_lib.DecodeSession(params, cfg, max_batch=8, max_len=cap)
    rng = np.random.default_rng(1)
    for slot, n in enumerate(prompt_lens):
        sess.prefill_into(slot, rng.integers(0, cfg.vocab_size, n),
                          seed=slot)
    sess.evict(7)
    fns = gen_lib.session_fns(cfg)
    state, ref = sess._state, _clone_state(sess._state)
    captures0, gaps = fns.captures, {}
    t0 = time.perf_counter()
    k3 = graph_against_eager(ops, fns, params, state, ref, cfg,
                             GRAPH_CHECK_STEPS, gaps)
    first_steps_s = time.perf_counter() - t0
    captured = fns.captures - captures0
    _sgd_in_place(params, seed=29)
    k3 += graph_against_eager(ops, fns, params, state, ref, cfg,
                              GRAPH_AFTER_STEPS, gaps)
    after_update = fns.captures - captures0
    swapped = None
    if swap:
        other = model_lib.init(cfg, seed=1, device="cuda")
        sess.params = other
        graph_against_eager(ops, fns, other, state, ref, cfg,
                            GRAPH_CHECK_STEPS, gaps)
        swapped = fns.captures - captures0
        sess.params = params
        graph_against_eager(ops, fns, params, state, ref, cfg, 2, gaps)
        del other
    attn, _ = kernel_layers(cfg)
    ms = _alternated_ms({
        "eager": lambda: gen_lib._host(gen_lib._session_step(
            params, ref, cfg=cfg)[1]),
        "graph": sess.step}, GRAPH_TIMED_STEPS)
    entry = fns.steps.get(state["pos"], fns.graph_key(params, state))
    replay_ms = event_ms(entry.graph.replay, reps=10)
    profiled_ms, busy_ms, kernels = _profiled(sess.step, GRAPH_PROFILED)
    emit("graph_session", arch=cfg.name, dtype=cfg.dtype, slots=8, cap=cap,
         num_groups=cfg.num_groups, active_slots=7, compiled=sess.compiled,
         checked_steps=GRAPH_CHECK_STEPS + GRAPH_AFTER_STEPS,
         gaps=gaps, captures=captured, captures_after_update=after_update,
         captures_after_swap=swapped, k3_per_step=k3 / (
             GRAPH_CHECK_STEPS + GRAPH_AFTER_STEPS), k3_layers=attn,
         first_steps_s=first_steps_s, eager_ms_per_step=ms["eager"],
         graph_ms_per_step=ms["graph"],
         graph_replay_device_ms=replay_ms,
         profiled_graph_step_ms=profiled_ms,
         device_busy_ms=busy_ms if busy_ms is not None else "not measured",
         device_idle_share=(1 - busy_ms / profiled_ms if busy_ms
                            else "not measured"), **kernels)
    _check_bitwise(f"graph_session {arch}", gaps)
    if not sess.compiled or captured != 1 or after_update != 1 \
            or (swap and swapped != 2):
        raise AssertionError(f"graph_session {arch}: compiled "
                             f"{sess.compiled}, captures {captured}, "
                             f"{after_update} after the update, {swapped} "
                             "after the swap; want 1, 1, 2")
    if k3 != attn * (GRAPH_CHECK_STEPS + GRAPH_AFTER_STEPS):
        raise AssertionError(f"graph_session {arch}: K3 {k3}, want "
                             f"{attn} a step")
    del sess, state, ref, params, entry
    torch.cuda.empty_cache()


def _eager_generate(params, prompt, seed, cfg, num_steps, vision):
    """``generate``'s loop by hand from the plain functions: the prefill,
    then ``_session_step`` on its own state."""
    import torch

    from repro_torch.core import generate as gen_lib
    b = prompt.shape[0]
    gens = [torch.Generator(device="cuda").manual_seed(seed + i)
            for i in range(b)]
    temp = torch.ones((b,), dtype=torch.float32, device="cuda")
    state, out = gen_lib._session_prefill(
        params, prompt, gens, temp, cfg=cfg,
        cache_seq_len=prompt.shape[1] + num_steps, vision=vision)
    outs = [out]
    for _ in range(num_steps - 1):
        state, out = gen_lib._session_step(params, state, cfg=cfg)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}


def phase_graph_vlm(ops):
    """29 for one Llama-3.2-Vision-90B group (phase 25's: bf16 on float32
    weights, B 4, VLM_PROMPT-token prompts with the seeded vision stub,
    VLM_GEN tokens): GRAPH_CHECK_STEPS compiled steps against eager on
    ``generate``'s static buffers, bitwise. Then 31d, the prefill with
    ``vision=`` through generate's admission graph: ``generate`` of 1
    token, eagerly then three times (warm, capture, replay), and of
    VLM_GEN tokens three times, against the eager loop, bitwise; one
    prefill capture a key, K2 of each prefill the eager one's, no new
    decode step capture; decode ms a step of each from the calls' times
    less a prefill's (the graph's less a replayed prefill's)."""
    import weakref

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import tree_map

    cfg = dataclasses.replace(get_config(VLM), num_groups=VLM_GROUPS,
                              attn_impl="kernel")
    params = model_lib.init(cfg, seed=0, device="cuda")
    b, cap = 4, VLM_PROMPT + VLM_GEN
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (b, VLM_PROMPT))
    vision = vision_stub(cfg, b, torch.bfloat16)
    fns = gen_lib.session_fns(cfg)
    captures0, gaps = fns.captures, {}
    gens = [torch.Generator(device="cuda").manual_seed(i) for i in range(b)]
    state, _ = fns.prefill(params, torch.as_tensor(prompt, device="cuda"),
                           gens, torch.ones((b,), device="cuda"),
                           cache_seq_len=cap, vision=vision)
    bufs = fns.buffers(params, b, cap)           # generate's, as it does
    tree_map(lambda dst, src: dst.copy_(src), bufs,
             {k: state[k] for k in bufs})
    state.update(bufs)
    ref = _clone_state(state)
    k3 = graph_against_eager(ops, fns, params, state, ref, cfg,
                             GRAPH_CHECK_STEPS, gaps)
    del state, ref
    fns.release(weakref.ref(params), b, cap, bufs)
    attn, _ = kernel_layers(cfg)
    if k3 != attn * GRAPH_CHECK_STEPS:
        raise AssertionError(f"graph_vlm: K3 {k3}, want {attn} a step")

    def timed(eager, num_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if eager:
            out = _eager_generate(params, torch.as_tensor(prompt,
                                                          device="cuda"),
                                  0, cfg, num_steps, vision)
            out["tokens"] = out.pop("token")
        else:
            out = gen_lib.generate(params, prompt, 0, cfg=cfg,
                                   num_steps=num_steps, vision=vision)
            out["tokens"] = out["tokens"][:, VLM_PROMPT:]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the prefill alone (1 token): eager, then through generate's
    # admission graph (warm, capture, replay), K2 as the eager prefill's
    admits0, prefill = fns.admissions.captures, {}
    for name in ("eager", "warm", "capture", "graph"):
        before = ops.stats()["flash_attention"]
        out, prefill[name] = timed(name == "eager", 1)
        prefill[name + "_k2"] = ops.stats()["flash_attention"] - before
        if name == "eager":
            first = out
        for k in ("tokens", "logprob", "entropy", "baseline"):
            gaps["prefill/" + k] = max(gaps.get("prefill/" + k, 0.0),
                                       _gap(out[k], first[k]))
    ms, outs = {}, {}
    for name in ("eager", "graph", "graph2", "graph3", "eager2"):
        outs[name], ms[name] = timed(name.startswith("eager"), VLM_GEN)
    for name in ("graph", "graph2", "graph3"):
        for k in ("tokens", "logprob", "entropy", "baseline"):
            gaps["generate/" + k] = max(gaps.get("generate/" + k, 0.0),
                                        _gap(outs[name][k], outs["eager"][k]))
    captured = fns.captures - captures0
    admits = fns.admissions.captures - admits0
    per_step = {name: (ms[name] - prefill["graph" if name.startswith(
        "graph") else "eager"]) / (VLM_GEN - 1) for name in ms}
    emit("graph_vlm", arch=cfg.name, dtype=cfg.dtype,
         num_groups=cfg.num_groups, batch=b, prompt_len=VLM_PROMPT,
         gen_tokens=VLM_GEN, checked_steps=GRAPH_CHECK_STEPS, gaps=gaps,
         captures=captured, prefill_captures=admits, k3=k3,
         prefill_ms=prefill, call_ms=ms,
         eager_ms_per_step=statistics.median(
             [per_step["eager"], per_step["eager2"]]),
         graph_ms_per_step=per_step["graph3"],
         note="31d: the prefill (the admission graph with vision=) keyed "
              "by (rows, prompt, vision, cache length): one key for the "
              "1-token calls, one for the VLM_GEN-token calls (graph: "
              "warm, graph2: capture, graph3: replay)")
    _check_bitwise("graph_vlm", gaps)
    k2 = {prefill[n + "_k2"] for n in ("eager", "warm", "capture", "graph")}
    if captured != 1 or admits != 2 or k2 != {attn}:
        raise AssertionError(f"graph_vlm: {captured} step captures (want "
                             f"1), {admits} prefill captures (want 2: one "
                             f"a key), prefill K2 {k2} (want {attn})")
    del params, outs, vision
    torch.cuda.empty_cache()


def phase_graph_source(ops):
    """29 for Granite lm-rl generation at full width (GRAPH_SOURCE_GROUPS
    of its groups): GeneratorSource
    (GLM_RL_ARGV's B 8, T 64) through the compiled session, two batches
    with an in-place SGD step of the weights between them, each against
    the same episodes generated eagerly (the source's prompts and seeds,
    ``_session_step`` on a session of its own): tokens and behaviour
    log-probs bitwise, K3 launches equal, one capture for both batches;
    generation ms of each."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.core.sources import GeneratorSource
    from repro_torch.models import model as model_lib

    b, t = 8, 64
    cfg = dataclasses.replace(get_config(GRANITE), attn_impl="kernel",
                              num_groups=GRAPH_SOURCE_GROUPS)
    params = model_lib.init(cfg, seed=0, device="cuda")
    source = GeneratorSource(cfg, batch_size=b, episode_length=t, seed=0)
    fns = gen_lib.session_fns(cfg)
    captures0, gaps, rounds = fns.captures, {}, []
    for round_ in range(2):
        saved = source._gen.get_state()
        before = ops.stats()["decode_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = source.next_batch(params)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) * 1e3
        k3 = ops.stats()["decode_attention"] - before
        gen = torch.Generator()
        gen.set_state(saved)
        prompt = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
        seeds = torch.randint(0, 2 ** 62, (b,), generator=gen)
        sess = gen_lib.DecodeSession(params, cfg, max_batch=b,
                                     max_len=t + 1)
        before = ops.stats()["decode_attention"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = sess.prefill_many(range(b), list(prompt.numpy()),
                                  seeds=seeds.tolist())
        toks, lps = [[f["token"] for f in first]], [[f["logprob"]
                                                     for f in first]]
        for _ in range(t - 1):
            o = gen_lib._host(gen_lib._session_step(params, sess._state,
                                                    cfg=cfg)[1])
            toks.append(o["token"])
            lps.append(o["logprob"])
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        k3_eager = ops.stats()["decode_attention"] - before
        del sess
        want_obs = torch.cat([prompt.T, torch.as_tensor(np.asarray(toks))])
        gaps["tokens"] = max(gaps.get("tokens", 0.0), _gap(
            batch["obs"].cpu().long(), want_obs.long()))
        gaps["behavior_logprob"] = max(gaps.get("behavior_logprob", 0.0), _gap(
            batch["behavior_logprob"].cpu(),
            torch.as_tensor(np.asarray(lps, np.float32))))
        rounds.append(dict(graph_ms=graph_ms, eager_ms=eager_ms, k3=k3,
                           k3_eager=k3_eager))
        if k3 != k3_eager:
            raise AssertionError(f"graph_source: K3 {k3}, eager {k3_eager}")
        if round_ == 0:
            _sgd_in_place(params, seed=30)
    captured = fns.captures - captures0
    emit("graph_source", arch=cfg.name, dtype=cfg.dtype, batch=b,
         episode_length=t, gaps=gaps, captures=captured, rounds=rounds,
         note="generation ms: prefill_many plus 63 steps, each with its "
              "host copy; round 0 includes the warm step and the capture")
    _check_bitwise("graph_source", gaps)
    if captured != 1:
        raise AssertionError(f"graph_source: {captured} captures, want 1")
    del params, source
    torch.cuda.empty_cache()


def phase29(ops):
    """29: the compiled decode step at full width against eager."""
    for arch, lens, cap, groups in GRAPH_SESSIONS:
        phase_graph_session(ops, arch, lens, cap, swap=arch == XLSTM,
                            groups=groups)
    phase_graph_vlm(ops)
    phase_graph_source(ops)


# ---------------------------------------------------------------------------
# 30. the compiled rl-agent entries and the admissions: CUDA graphs of the
# learner steps, the unroll and the admissions against eager


def _note_tree(gaps, prefix, got, want):
    """Each leaf's gap (``_gap``) of two trees into ``gaps``, worst kept."""
    from repro_torch.tree import flatten
    for (path, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
        key = prefix + path
        gaps[key] = max(gaps.get(key, 0.0), _gap(a, b))


def _held(phase, gaps, eager_gaps):
    """Each product's graph-vs-eager gap within twice its eager-vs-eager
    gap from the same state (0: bitwise). Returns the products whose eager
    runs were not bitwise, with their gaps."""
    loose = {k: v for k, v in eager_gaps.items() if v != 0.0}
    bad = {k: (v, 2 * eager_gaps.get(k, 0.0)) for k, v in gaps.items()
           if not v <= 2 * eager_gaps.get(k, 0.0)}
    if bad:
        raise AssertionError(f"{phase}: graph against eager (gap, bar): "
                             f"{bad}")
    return loose


def phase_graph_learner(ops, recurrent):
    """30a: the full-width learner step (phase 4's deep ResNet on its
    seeded batch, or phase 18b's recurrent agent on its) through
    ``compiled.TrainStep`` against the plain step from the same weights,
    GRAPH_LEARNER_STEPS steps of TRAIN's linear anneal (a new rate each
    step), cuDNN pinned deterministic: the loss and every metric, every
    parameter and every RMSProp leaf, held to twice a second eager run's
    gap (0: bitwise); one capture; K1 once a graph step. Then ms a step,
    eager and graph in turns. Returns K1's launches in the graph steps."""
    import copy

    import torch

    from repro_torch.configs.atari_impala import NUM_ACTIONS, OBS_SHAPE, TRAIN
    from repro_torch.core import compiled
    from repro_torch.core import learner as learner_lib
    from repro_torch.models.convnet import impala_deep, minatar_lstm_net
    from repro_torch.optim import make_optimizer

    t, b = TRAIN.unroll_length, TRAIN.batch_size
    net = minatar_lstm_net if recurrent else impala_deep
    agent = net(OBS_SHAPE, NUM_ACTIONS,
                generator=torch.Generator().manual_seed(0)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = (recurrent_batch(gen, t, b, agent.core_size) if recurrent
             else synthetic_batch(gen, t, b))
    opt = make_optimizer(TRAIN)
    plain = (learner_lib.make_recurrent_train_step if recurrent
             else learner_lib.make_train_step)(opt, TRAIN)
    graph = compiled.TrainStep(plain, opt)
    agents = {"graph": agent, "eager": copy.deepcopy(agent),
              "eager2": copy.deepcopy(agent)}
    states = {k: opt.init(list(a.parameters())) for k, a in agents.items()}
    gaps, eager_gaps, k1, rates = {}, {}, [], []
    with cudnn_deterministic():
        for step in range(GRAPH_LEARNER_STEPS):
            before = ops.stats()["vtrace"]
            _, _, got = graph(agents["graph"], states["graph"], step, batch)
            k1.append(ops.stats()["vtrace"] - before)
            rates.append(-float(opt.stage(step, "cuda")["neg_lr"]))
            out = {k: plain(agents[k], states[k], step, batch)[2]
                   for k in ("eager", "eager2")}
            for name, tree in (("metrics/", lambda k: out[k]),
                               ("params/", lambda k: dict(
                                   agents[k].named_parameters())),
                               ("opt_state/", lambda k: states[k])):
                want = (got if name == "metrics/" else tree("graph"))
                _note_tree(gaps, name, want, tree("eager"))
                _note_tree(eager_gaps, name, tree("eager2"), tree("eager"))
        ms = _alternated_ms({
            "eager": lambda: plain(agents["eager"], states["eager"],
                                   GRAPH_LEARNER_STEPS, batch),
            "graph": lambda: graph(agents["graph"], states["graph"],
                                   GRAPH_LEARNER_STEPS, batch)},
            GRAPH_TIMED)
    part = "recurrent" if recurrent else "deep"
    loose = _held(f"graph_learner {part}", gaps, eager_gaps)
    emit("graph_learner", part=part, obs=list(OBS_SHAPE), T=t, B=b,
         steps=GRAPH_LEARNER_STEPS, rates=rates,
         products=len(gaps), worst_gap=max(gaps.values()),
         eager_not_bitwise=loose, captures=graph.captures,
         vtrace_launches=k1, eager_ms_per_step=ms["eager"],
         graph_ms_per_step=ms["graph"])
    if graph.captures != 1 or k1 != [1] * GRAPH_LEARNER_STEPS \
            or len(set(rates)) != GRAPH_LEARNER_STEPS:
        raise AssertionError(f"graph_learner {part}: captures "
                             f"{graph.captures}, K1 {k1}, rates {rates}")
    del agents, states, batch, graph
    torch.cuda.empty_cache()
    return sum(k1)


def phase_graph_unroll(ops, env_name, deep):
    """30b: the trainer's device actors (``DeviceSource``, pipelined, T 20,
    B 32; gridworld with the deep agent, Catch with the MinAtar one)
    through the unroll's CUDA graph against the plain unroll dispatched
    the same way from the same seed: GRAPH_UNROLL_CALLS ``next_batch``
    calls with the learner's weights moved in place (an SGD step) between
    them, then a ``state_dict`` round trip into a fresh source and three
    calls more; every rollout, the carry and the generator's state after
    every call, bitwise; one capture a source. Then unroll ms, eager and
    graph in turns, and each one's device idle share under
    torch.profiler."""
    import copy

    import torch

    from repro_torch.core import rollout as rollout_lib
    from repro_torch.core.sources import DeviceSource
    from repro_torch.envs import catch, gridworld
    from repro_torch.models.convnet import impala_deep, minatar_net
    from repro_torch.tree import map_leaves

    t, b = TRAINER_SHAPE
    env = {"catch": catch, "gridworld": gridworld}[env_name].make()
    agent = (impala_deep if deep else minatar_net)(
        env.obs_shape, env.num_actions,
        generator=torch.Generator().manual_seed(0)).cuda()
    source = DeviceSource.for_env(env, agent, unroll_length=t, batch_size=b,
                                  seed=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ref = {"carry": rollout_lib.env_reset_batch(env, gen, b, "cuda"),
           "actor": copy.deepcopy(agent).requires_grad_(False), "out": []}
    unroll = rollout_lib.make_unroll(env, t)
    gaps = {}

    def eager_dispatch():
        ref["actor"].load_state_dict(agent.state_dict())
        ref["carry"], ro = unroll(ref["actor"], ref["carry"], gen)
        ref["out"].append(ro)

    def call(n):
        if n == 0:
            eager_dispatch()
        eager_dispatch()
        _note_tree(gaps, "rollout/", source.next_batch(agent), ref["out"][n])
        _note_tree(gaps, "carry/", source._carry, ref["carry"])
        _note_tree(gaps, "generator/", source._gen.get_state(),
                   gen.get_state())
        _sgd_in_place(agent, seed=300 + n)

    for n in range(GRAPH_UNROLL_CALLS):
        call(n)
    captures = [source.captures]
    saved = map_leaves(lambda x: x.detach().cpu().clone()
                       if isinstance(x, torch.Tensor) else x,
                       source.state_dict())
    source.stop()
    source = DeviceSource.for_env(env, agent, unroll_length=t, batch_size=b,
                                  seed=99)
    source.load_state_dict(saved)
    for n in range(GRAPH_UNROLL_CALLS, GRAPH_UNROLL_CALLS + 3):
        call(n)
    captures.append(source.captures)
    actor = source._actor
    ms = _alternated_ms({
        "eager": lambda: unroll(ref["actor"], ref["carry"], gen),
        "graph": lambda: source._unroll(actor)}, GRAPH_TIMED)
    eager_prof = _profiled(lambda: unroll(ref["actor"], ref["carry"], gen),
                           3)
    graph_prof = _profiled(lambda: source._unroll(actor), GRAPH_TIMED)

    def idle(prof):
        host_ms, busy_ms, _ = prof
        return 1 - busy_ms / host_ms if busy_ms else "not measured"

    emit("graph_unroll", env=env_name, agent="deep" if deep else "minatar",
         T=t, B=b, calls=GRAPH_UNROLL_CALLS + 3, products=len(gaps),
         gaps={k: v for k, v in gaps.items() if v}, captures=captures,
         eager_unroll_ms=ms["eager"], graph_unroll_ms=ms["graph"],
         eager_profiled_ms=eager_prof[0], graph_profiled_ms=graph_prof[0],
         eager_device_busy_ms=eager_prof[1], graph_device_busy_ms=graph_prof[1],
         eager_device_idle_share=idle(eager_prof),
         graph_device_idle_share=idle(graph_prof),
         graph_launches_per_call=graph_prof[2]["launches_per_call"])
    _check_bitwise(f"graph_unroll {env_name}", gaps)
    if captures != [1, 1]:
        raise AssertionError(f"graph_unroll {env_name}: captures {captures}"
                             ", want one a source")
    del source, ref, agent
    torch.cuda.empty_cache()


def _eager_admit(cfg, params, state, slots, prompts, seeds, cap):
    """``_SessionFns.admit``'s eager branch from the plain functions:
    ``_session_admit``, then the per-slot sampling."""
    import numpy as np
    import torch

    from repro_torch.core import generate as gen_lib
    n = len(slots)
    pb = gen_lib.prefill_len(cfg, len(prompts[0]), cap)
    padded = np.zeros((n, pb), np.int64)
    for row, p in enumerate(prompts):
        padded[row, :len(p)] = p
    inputs = torch.from_numpy(np.concatenate(
        [padded.reshape(-1), [len(p) for p in prompts], slots]).astype(
            np.int64)).cuda()
    logits0, base0 = gen_lib._session_admit(params, state, inputs, n, pb,
                                            cfg=cfg, cache_seq_len=cap)
    idx = inputs[n * pb + n:]
    gens = [state["gens"][s].manual_seed(int(seed))
            for s, seed in zip(slots, seeds)]
    temp = torch.ones((n,), device="cuda")
    tok, lp, ent = gen_lib._sample(logits0[:, 0], temp, gens,
                                   np.ones(n, bool))
    state["last"][idx] = tok
    state["temp"][idx] = temp
    state["active"][slots] = True
    return gen_lib._host(gen_lib._out(tok, lp, ent, base0))


def _pool_bytes(pool):
    """Bytes of the caching allocator's segments in graph memory pool
    ``pool``; None where the snapshot does not say."""
    import torch
    if pool is None:
        return None
    segs = [s for s in torch.cuda.memory_snapshot()
            if "segment_pool_id" in s]
    if not segs:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def phase_graph_admit(ops, arch, cap, lens, groups=None):
    """30c: admissions into a full-width 8-slot session (bf16 on float32
    weights from seed 0, ``groups`` of its groups where given, ``cap``-slot
    caches) through their CUDA graphs
    against ``_SessionFns.admit``'s eager branch on a clone of the state:
    prefill_many of 4 prompts into slots 0-3 and of 4 into slots 4-7 (two
    prefill buckets, ``lens``), and prefill_into of one into slot 0, each
    GRAPH_ADMIT_ROUNDS times (warm, capture, replay): first tokens,
    log-probs, entropies, baselines, every cache leaf, pos and last,
    bitwise; one capture per (rows, bucket); the K2 and K4 launches of
    every graph admission those of the eager one. Then ms an admission of
    4 rows, eager and graph in turns, and the admissions' graph pool
    bytes. Returns the graph admissions' launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import generate as gen_lib
    from repro_torch.models import model as model_lib

    cfg = dataclasses.replace(
        get_config(arch), attn_impl="kernel", ssd_impl="kernel",
        num_groups=groups or get_config(arch).num_groups)
    params = model_lib.init(cfg, seed=0, device="cuda")
    sess = gen_lib.DecodeSession(params, cfg, max_batch=8, max_len=cap)
    fns = gen_lib.session_fns(cfg)
    captures0 = fns.admissions.captures
    ref = _clone_state(sess._state)
    rng = np.random.default_rng(30)
    names = ("flash_attention", "ssd_chunk")
    groups = [(list(range(4)), lens[0]), (list(range(4, 8)), lens[1]),
              ([0], lens[0][:1])]
    gaps, launches = {}, dict.fromkeys(names, 0)

    call_ms = {}

    def admit(slots, prompts, seeds, many=True):
        for s in slots:
            sess.evict(s)
        before = ops.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if many:
            got = sess.prefill_many(slots, prompts, seeds=seeds)
        else:
            got = [sess.prefill_into(slots[0], prompts[0], seed=seeds[0])]
        torch.cuda.synchronize()
        call_ms.setdefault(f"{len(slots)}x{len(prompts[0])}", []).append(
            (time.perf_counter() - t0) * 1e3)
        mid = ops.stats()
        want = _eager_admit(cfg, params, ref, slots, prompts, seeds, cap)
        after = ops.stats()
        for k in names:
            g, e = mid[k] - before[k], after[k] - mid[k]
            if g != e:
                raise AssertionError(f"graph_admit {arch}: {k} {g} in the "
                                     f"graph admission, {e} eager")
            launches[k] += g
        for k in want:
            gaps[k] = max(gaps.get(k, 0.0), _gap(
                torch.as_tensor(np.stack([o[k] for o in got])),
                torch.as_tensor(want[k])))

    for r in range(GRAPH_ADMIT_ROUNDS):
        for i, (slots, lens_) in enumerate(groups):
            prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens_]
            admit(slots, prompts, [100 * r + 10 * i + s for s in slots],
                  many=len(slots) > 1)
            _note_tree(gaps, "cache/", sess._state["cache"], ref["cache"])
            for k in ("pos", "last", "temp"):
                _note_tree(gaps, k, sess._state[k], ref[k])
    captured = fns.admissions.captures - captures0
    capture_s = fns.admissions.capture_s
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens[0]]
    slots = list(range(4))

    def timed(eager):
        for s in slots:
            sess.evict(s)
        if eager:
            return _eager_admit(cfg, params, ref, slots, prompts, slots, cap)
        return sess.prefill_many(slots, prompts, seeds=slots)

    ms = _alternated_ms({"eager": lambda: timed(True),
                         "graph": lambda: timed(False)}, GRAPH_TIMED)
    pool = _pool_bytes(fns.admissions._pool)
    emit("graph_admit", arch=cfg.name, dtype=cfg.dtype, slots=8, cap=cap,
         lens=[list(x) for x in lens], rounds=GRAPH_ADMIT_ROUNDS,
         products=len(gaps), gaps={k: v for k, v in gaps.items() if v},
         captures=captured, keys=len(groups), launches=launches,
         warm_capture_replay_ms=call_ms, capture_s=capture_s,
         eager_ms_per_admission=ms["eager"],
         graph_ms_per_admission=ms["graph"],
         graph_pool_bytes=pool if pool is not None else "not measured")
    _check_bitwise(f"graph_admit {arch}", gaps)
    if captured != len(groups):
        raise AssertionError(f"graph_admit {arch}: {captured} captures for "
                             f"{len(groups)} (rows, bucket) keys")
    del sess, ref, params
    torch.cuda.empty_cache()
    return launches


def phase30(ops):
    """30: the compiled rl-agent entries and the admissions at full width
    against eager. Returns each part's kernel launches."""
    out = {"graph_learner": {"vtrace": phase_graph_learner(ops, False)
                             + phase_graph_learner(ops, True)}}
    phase_graph_unroll(ops, "gridworld", deep=True)
    phase_graph_unroll(ops, "catch", deep=False)
    for arch, cap, lens, groups in GRAPH_ADMITS:
        out[f"graph_admit_{arch}"] = phase_graph_admit(ops, arch, cap, lens,
                                                       groups)
    return out


# ---------------------------------------------------------------------------
# 31. the compiled LM learner steps, the host actors' policy and replay's
# value function (the VLM's prefill: phase 29's graph_vlm): CUDA graphs
# against eager


def _lm_state(params, opt_state):
    return {"params": dict(params.named_parameters()),
            "opt_state": opt_state}


def _kept(tree, device, pin=False):
    """Each leaf of ``tree`` copied to ``device`` (with ``pin``, pinned
    host memory), by path."""
    import torch

    from repro_torch.tree import flatten
    if not pin:
        return {path: x.detach().to(device, copy=True)
                for path, x in flatten(tree)}
    return {path: torch.empty(x.shape, dtype=x.dtype,
                              pin_memory=True).copy_(x.detach())
            for path, x in flatten(tree)}


def _digests(tree, chunk=1 << 26):
    """Each leaf's fingerprint by path: two int64 sums over its 32-bit
    words, one plain and one weighted by position (mod 65521), and the
    sum of its trailing bytes, taken on the card. Equal bits give equal
    fingerprints; a leaf that differs is caught but for a deliberate
    collision."""
    import torch

    from repro_torch.tree import flatten
    out = {}
    for path, x in flatten(tree):
        b = x.detach().reshape(-1).view(torch.uint8)
        n = b.numel() // 4 * 4
        w = b[:n].view(torch.int32)
        sums = [b[n:].long().sum()]
        for i in range(0, w.numel(), chunk):
            c = w[i:i + chunk].long()
            pos = torch.arange(i, i + c.numel(), device=c.device) % 65521
            sums += [c.sum(), (c * (pos + 1)).sum()]
        out[path] = tuple(torch.stack(sums).tolist())
    return out


def _gaps_to_kept(gaps, tree, kept):
    """Each leaf's gap to its kept copy (moved back one leaf at a time)
    into ``gaps``, worst kept."""
    from repro_torch.tree import flatten
    for path, x in flatten(tree):
        gaps[path] = max(gaps.get(path, 0.0),
                         _gap(x, kept[path].to(x.device)))


def phase_graph_lm_learner(ops, argv, host):
    """31a: one LM trainer's learner step at full width (``argv``'s arch,
    shapes and impls, ``--steps`` GRAPH_LM_STEPS), built by
    ``train.build_lm_rl`` / ``build_lm``: its ``compiled.TrainStep``
    against the plain step it wraps, from the built state (the weights and
    AdamW's zeros), on GRAPH_LM_STEPS batches the built source draws first
    from those weights (lm's corpus; lm-rl's one batch of episodes of the
    compiled session, its columns rotated for each later step). The eager
    run goes first and its final state is kept; the built state is
    restored and the graph run (warm, capture, replay) is held to it:
    every metric, parameter and AdamW leaf bitwise, or, where not, within
    twice the gap of a second eager run from the same state. One capture;
    K1, K2 and K4 launches of each step of both runs equal to
    ``remat_step_launches`` (K1 once an lm-rl step); the optimizer's
    staged scalars new each step. ``host``: the built state lies in pinned
    host memory (two Qwen3-4B or Zamba2-2.7B states with AdamW's do not
    fit the card beside a step) and the eager final state is held by each
    leaf's fingerprint (``_digests``); where one differs, both runs go
    again with that state kept in host memory and compared by value. The
    graph is released before a second eager run. Reports each run's ms a
    step and peak memory (the graph run's pool included). Returns the
    graph run's launches."""
    import gc

    import torch

    from repro_torch.launch import train
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    args = train._parser().parse_args(
        list(argv) + ["--steps", str(GRAPH_LM_STEPS)])
    build = train.build_lm_rl if args.mode == "lm-rl" else train.build_lm
    cfg = train._lm_config(args)
    source, graph, params, opt_state, _ = build(args)
    plain, opt = graph.step_fn, graph.opt
    if args.mode == "lm-rl":
        # one generated batch (seconds at full width), its episodes
        # rotated along the batch for the later steps
        first = source.next_batch(params)
        batches = [{k: v.roll(i, dims=1) for k, v in first.items()}
                   for i in range(GRAPH_LM_STEPS)]
    else:
        batches = [source.next_batch(params) for _ in range(GRAPH_LM_STEPS)]
    source.stop()
    del source
    keep = "cpu" if host else "cuda"
    built_s = time.perf_counter() - t0
    start = _kept(dict(params.named_parameters()), keep, pin=host)
    kept_s = time.perf_counter() - t0 - built_s
    if any(bool(x.any()) for x in leaves(opt_state)):
        raise AssertionError(f"graph_lm {cfg.name}: AdamW state not zero")
    want = {**dict.fromkeys(ops.stats(), 0),
            **remat_step_launches(cfg, args.seq),
            "vtrace": int(args.mode == "lm-rl")}

    def run(step_fn):
        with torch.no_grad():
            for path, x in params.named_parameters():
                x.copy_(start[path])
            for x in leaves(opt_state):
                x.zero_()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = dict(metrics=[], launches=[], ms=[], scalars=[],
                   allocated_at_start=torch.cuda.memory_allocated())
        for step, batch in enumerate(batches):
            before = ops.stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, metrics = step_fn(params, opt_state, step, batch)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["launches"].append({k: v - before[k]
                                    for k, v in ops.stats().items()})
            out["metrics"].append({k: v.clone() for k, v in metrics.items()})
            out["scalars"].append(tuple(
                float(v) for v in opt.stage(step, "cuda").values()))
        out["peak_allocated"] = torch.cuda.max_memory_allocated()
        out["peak_reserved"] = torch.cuda.max_memory_reserved()
        return out

    eager = run(plain)
    state = _lm_state(params, opt_state)
    gaps, eager_gaps, kept = {}, {}, None
    if host:
        # two such states and a step do not fit the card, and a host copy
        # of 48 GB takes tens of seconds: held by fingerprints, and only
        # where they differ, again with the eager state kept on the host
        prints = _digests(state)
        got = run(graph)
        if _digests(state) != prints:
            run(plain)
            kept = _kept(state, keep)
            got = run(graph)
        else:
            gaps.update(dict.fromkeys(prints, 0.0))
    else:
        kept = _kept(state, keep)
        got = run(graph)
    for step in range(GRAPH_LM_STEPS):
        _note_tree(gaps, f"metrics/{step}/", got["metrics"][step],
                   eager["metrics"][step])
    if kept is not None:
        _gaps_to_kept(gaps, state, kept)
    captures = graph.captures
    del graph
    gc.collect()
    if any(gaps.values()):
        # a second eager run from the same state: each product's bar (the
        # graph and its pool freed first)
        eager2 = run(plain)
        for step in range(GRAPH_LM_STEPS):
            _note_tree(eager_gaps, f"metrics/{step}/",
                       eager2["metrics"][step], eager["metrics"][step])
        if kept is not None:
            _gaps_to_kept(eager_gaps, state, kept)
    loose = _held(f"graph_lm {cfg.name}", gaps, eager_gaps)
    emit("graph_lm", arch=cfg.name, mode=args.mode, dtype=cfg.dtype,
         batch=args.batch, seq=args.seq, remat=cfg.remat,
         steps=GRAPH_LM_STEPS, kept_on=keep,
         held_by="fingerprints" if kept is None else "values",
         products=len(gaps), worst_gap=max(gaps.values()),
         eager2_run=bool(eager_gaps), eager_not_bitwise=loose,
         captures=captures, want_launches=want,
         launches={"eager": eager["launches"], "graph": got["launches"]},
         scalars=got["scalars"], ms={"eager": eager["ms"],
                                     "graph": got["ms"]},
         eager_ms_per_step=statistics.median(eager["ms"][1:]),
         graph_ms_per_step=got["ms"][-1],
         allocated_at_start={"eager": eager["allocated_at_start"],
                             "graph": got["allocated_at_start"]},
         peak_allocated={"eager": eager["peak_allocated"],
                         "graph": got["peak_allocated"]},
         peak_reserved={"eager": eager["peak_reserved"],
                        "graph": got["peak_reserved"]},
         loss=[float(m["loss"]) for m in got["metrics"]],
         seconds=dict(build=built_s, keep_start=kept_s,
                      total=time.perf_counter() - t0),
         note="ms: synchronised host clock a step; the graph run's steps "
              "are the warm call, the capture with its replay, a replay; "
              "allocated_at_start: the state and whatever copies of it "
              "this check keeps on the card")
    bad = [i for i, (e, g) in enumerate(zip(eager["launches"],
                                            got["launches"]))
           if not e == g == want]
    if captures != 1 or bad or len(set(got["scalars"])) != GRAPH_LM_STEPS:
        raise AssertionError(
            f"graph_lm {cfg.name}: captures {captures}, steps {bad} launched "
            f"other than {want}, scalars {got['scalars']}")
    launches = {k: sum(step[k] for step in got["launches"]) for k in want}
    del params, opt_state, opt, batches, kept, start, plain, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _np_gap(got, want):
    """``_gap`` of two numpy arrays."""
    import torch
    return _gap(torch.from_numpy(got), torch.from_numpy(want))


def phase_graph_policy(runtime, seconds, last):
    """31b, on phase 7's run (``train.main(HOST_ARGV)``, its ``runtime``,
    seconds and last line, just returned): the host actors' policy
    (``HostLoopSource.policy``, ``compiled.Forward``) a CUDA graph per
    padded batch, captured on the inference thread; the run's
    ``compiled:`` line. Then on the run's source: each bucket of the
    ladder up to the 8 actors (POLICY_BUCKETS), GRAPH_POLICY_CALLS calls
    on seeded observations against the eager forward of the actor copy,
    bitwise; one capture a bucket; an in-place update of the learner's
    weights synced into the copy (``_sync``), read by the next replay (no
    new capture; bitwise the new weights' eager logits, not the old
    ones). ms a host step; ms a policy call of 8, eager and graph."""
    import numpy as np
    import torch

    from repro_torch.envs import gridworld

    line = _compiled_line()
    source = runtime.source
    run_captures = source.policy.captures
    rng = np.random.default_rng(31)
    shape = gridworld.make().obs_shape

    def eager(obs):
        with torch.no_grad():
            return source._actor(torch.from_numpy(obs).cuda()) \
                .policy_logits.float().cpu().numpy()

    gaps = {}
    for n in POLICY_BUCKETS:
        for _ in range(GRAPH_POLICY_CALLS):
            obs = rng.random((n,) + shape, dtype=np.float32)
            key = f"bucket_{n}"
            gaps[key] = max(gaps.get(key, 0.0),
                            _np_gap(source._policy(obs), eager(obs)))
    captures, keys = source.policy.captures, len(source.policy._static)
    obs = rng.random((POLICY_BUCKETS[-1],) + shape, dtype=np.float32)
    old = source._policy(obs)
    _sgd_in_place(runtime.params, seed=31)
    source._sync(runtime.params)
    new = source._policy(obs)
    gaps["after_sync"] = _np_gap(new, eager(obs))
    moved = _np_gap(new, old)
    ms = _alternated_ms({"eager": lambda: eager(obs),
                         "graph": lambda: source._policy(obs)}, 20)
    emit("graph_policy", argv=HOST_ARGV, compiled=line, seconds=seconds,
         ms_per_step=seconds / HOST_STEPS * 1e3, fps_line=last,
         run_captures=run_captures,
         buckets=list(POLICY_BUCKETS), calls=GRAPH_POLICY_CALLS,
         captures=captures, keys=keys,
         captures_after_sync=source.policy.captures, gaps=gaps,
         sync_moved_logits=moved, policy_ms=ms)
    _check_bitwise("graph_policy", gaps)
    if "the host actors' policy" not in line or captures != keys \
            or keys != len(POLICY_BUCKETS) or not moved \
            or source.policy.captures != captures:
        raise AssertionError(
            f"graph_policy: {line!r}, captures {captures} for {keys} keys, "
            f"{source.policy.captures} after the sync, logits moved {moved}")


def phase_graph_value(ops):
    """31c: replay's value function (``build_rl_agent``'s ReplaySource
    ``value_fn``, ``compiled.Forward`` of the baseline head) for phase
    5b's run (gridworld, the deep agent, --replay elite) on observations
    of its unroll's shape less the bootstrap row (T 20, B 32) against the
    eager baseline of the same weights, bitwise: GRAPH_VALUE_CALLS calls
    (warm, capture, replays), then one after an in-place weight update
    (no new capture); ms a call, eager and graph."""
    import torch

    from repro_torch.envs import gridworld
    from repro_torch.launch import train

    args = train._parser().parse_args(TRAINER_ARGV + ["--replay", "elite"])
    source, _, agent, _, _ = train.build_rl_agent(args)
    value_fn = source._value_fn
    gen = torch.Generator(device="cuda").manual_seed(31)
    shape = TRAINER_SHAPE + gridworld.make().obs_shape

    def eager(obs):
        with torch.no_grad():
            return agent(obs).baseline

    gaps = {"values": 0.0}
    for call in range(GRAPH_VALUE_CALLS + 1):
        if call == GRAPH_VALUE_CALLS:
            captures = value_fn.captures
            _sgd_in_place(agent, seed=32)
        obs = torch.rand(shape, generator=gen, device="cuda")
        gaps["values"] = max(gaps["values"],
                             _gap(value_fn(agent, obs), eager(obs)))
    ms = _alternated_ms({"eager": lambda: eager(obs),
                         "graph": lambda: value_fn(agent, obs)}, 20)
    emit("graph_value", obs=list(shape), calls=GRAPH_VALUE_CALLS + 1,
         gaps=gaps, captures=captures,
         captures_after_update=value_fn.captures, ms_per_call=ms)
    _check_bitwise("graph_value", gaps)
    if captures != 1 or value_fn.captures != 1:
        raise AssertionError(f"graph_value: captures {captures}, "
                             f"{value_fn.captures} after the update")
    del source, agent
    torch.cuda.empty_cache()


def phase31(ops):
    """31: the compiled LM learner steps at full width (31a) and replay's
    value function (31c) against eager (31b runs on phase 7's run, 31d in
    phase 29's VLM group). Returns 31a's launches, a case each."""
    out = {}
    for argv, host, groups in GRAPH_LM_CASES:
        with train_depth(groups):
            out[f"graph_lm_{_arg(argv, '--arch')}"] = \
                phase_graph_lm_learner(ops, argv, host)
    phase_graph_value(ops)
    return out


# ---------------------------------------------------------------------------
# 32. slice 19: the four families no earlier phase runs


def phase32(ops):
    """32a: each of FAMILY_MODELS in float32, the kernel path against the
    plain path (``phase_model``: logits within MODEL_TOL, K2 once a layer
    and K3 once a layer a step, Mixtral's routing unflipped); 32b: each
    served in bf16 at the same depth (``phase_serve``: every request
    served and echoed, launches exact) and its compiled decode step held
    bitwise against eager (``phase_graph_session``: one capture). Returns
    32b's server launches, a family each."""
    import torch
    for arch, groups, batch, prompt_len, _ in FAMILY_MODELS:
        phase_model(ops, arch, prompt_len, phase="family", groups=groups,
                    batch=batch)
    launches = {}
    for arch, groups, _, _, requests in FAMILY_MODELS:
        argv = ["--arch", arch, "--requests", str(requests), *FAMILY_SERVE]
        launches[f"family_serve_{arch}"] = phase_serve(
            ops, argv, phase="family_serve", groups=groups)
        torch.cuda.empty_cache()
        phase_graph_session(ops, arch, *FAMILY_SESSION, groups=groups)
    return launches


# ---------------------------------------------------------------------------
# 33. slice 20: the four families trained


def family_train_argv(arch, mode, batch, seq):
    """A phase-33 run's ``train.main`` arguments: the kernel paths, 1
    step."""
    return ["--mode", mode, "--arch", arch, "--attn-impl", "kernel",
            "--vtrace-impl", "kernel", "--batch", str(batch), "--seq",
            str(seq), "--steps", "1"]


def phase33(ops):
    """33: each of FAMILY_TRAIN through ``train.main`` at every published
    width, cut to its groups (``depth_cut``): --mode lm-rl at
    LM_RL_SHAPE's B and T (``phase_lm_rl``) and --mode lm at its batch and
    sequence (``phase_lm``), each with its float32 kernel-against-plain
    step, then 31a's graph-against-eager check of the same arguments
    (``phase_graph_lm_learner``, the built state in pinned host memory).
    Returns the main runs' and the graph runs' launches, a run each."""
    import torch

    t, b = LM_RL_SHAPE
    t0 = time.perf_counter()
    emit("family_train_start", reserved=torch.cuda.memory_reserved(),
         allocated=torch.cuda.memory_allocated())
    launches = {}
    for arch, rl_groups, lm_groups, batch, seq in FAMILY_TRAIN:
        for mode, groups, run_batch, run_seq, phase in (
                ("lm-rl", rl_groups, b, t, phase_lm_rl),
                ("lm", lm_groups, batch, seq, phase_lm)):
            argv = family_train_argv(arch, mode, run_batch, run_seq)
            with train_depth(groups):
                launches[f"family_{mode}_{arch}"] = phase(
                    ops, argv, phase=f"family_{mode.replace('-', '_')}")
                torch.cuda.empty_cache()
                launches[f"graph_family_{mode}_{arch}"] = \
                    phase_graph_lm_learner(ops, argv, True)
    emit("family_train", runs=len(launches) // 2,
         seconds=time.perf_counter() - t0)
    return launches


# ---------------------------------------------------------------------------
# 34. slice 21: the repository's examples on the port


def _example(ops, main, argv):
    """``main(argv)`` of one example with its printed lines captured and
    echoed. Returns what it returned, its lines, its kernel launches (the
    counts set to 0 just before it), and its synchronised host seconds
    and peak memory."""
    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.stats()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print("  " + line, flush=True)
    return out, lines, launches, dict(
        seconds=seconds, peak_mem_bytes=torch.cuda.max_memory_allocated())


def _launches(**counts):
    """A run's expected launches: ``counts``, every other kernel 0."""
    return {"vtrace": 0, "flash_attention": 0, "decode_attention": 0,
            "ssd_chunk": 0, **counts}


def _exact(phase, launches, want):
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")


def phase_example_quickstart(ops):
    """34a: ``quickstart.main([])``: 3 host-actor steps, then Catch on the
    device actors to a solve (K1 once a step, 3 + 1,500); its final line
    must say SOLVED."""
    from repro_torch.examples import quickstart
    args = quickstart._parser().parse_args([])
    out, lines, launches, cost = _example(ops, quickstart.main, [])
    want = _launches(vtrace=3 + args.steps)
    emit("example_quickstart", final_reward_per_step=out["reward_per_step"],
         done_line=lines[-1], host_seconds=out["host_seconds"],
         device_seconds=out["device_seconds"],
         device_ms_per_step=out["device_seconds"] / args.steps * 1e3,
         fps_line=[ln for ln in lines if ln.startswith("step")][-1],
         launches=launches, want_launches=want, **cost)
    if not (math.isfinite(out["reward_per_step"]) and out["solved"]
            and lines[-1].endswith("(SOLVED)")):
        raise AssertionError(f"quickstart: {lines[-1]}")
    _exact("example_quickstart", launches, want)
    return launches


def _lagged_actor(ablation, args):
    """The ablation's corrected arm at a lag of EXAMPLE_LAG on the card
    (the unroll a CUDA graph reading the actors' copy by address): at
    each of 2 x lag + 1 steps the copy holds the learner's weights of the
    last sync, bitwise, and the rollout's first behaviour logits are that
    copy's forward, bitwise; between syncs the learner's own forward
    differs from them."""
    import copy

    import torch
    source, step_fn, agent, opt = ablation.build(True, EXAMPLE_LAG,
                                                 args.steps, lr=args.lr)
    opt_state = opt.init(list(agent.parameters()))
    actor_gaps, logit_gaps, differs = [], [], []
    for step in range(2 * EXAMPLE_LAG + 1):
        if step % EXAMPLE_LAG == 0:
            synced = copy.deepcopy(agent)
        batch = source.next_batch(agent)
        actor_gaps.append(max(
            _gap(a, b) for a, b in zip(source._actor.state_dict().values(),
                                       synced.state_dict().values())))
        with torch.no_grad():
            first = synced(batch["obs"][0]).policy_logits
            now = agent(batch["obs"][0]).policy_logits
        logit_gaps.append(_gap(batch["behavior_logits"][0], first))
        if step % EXAMPLE_LAG:
            differs.append(not torch.equal(now, first))
        agent, opt_state, _ = step_fn(agent, opt_state, step, batch)
    return {"lag": EXAMPLE_LAG, "steps": 2 * EXAMPLE_LAG + 1,
            "actor_gaps": actor_gaps, "logit_gaps": logit_gaps,
            "learner_differs_between_syncs": differs,
            "unroll_captures": source.captures}


def phase_example_ablation(ops):
    """34b: ``vtrace_ablation.main(ABLATION_ARGV)``: the four arms (K1
    once a step, 4 x 700), each one's mean final reward and ms a step;
    then, cuDNN pinned deterministic, the uncorrected arm's log rho
    exactly 0 on one batch, its captured step (``compiled.TrainStep`` over
    the user-written step) against that step run eagerly from one state
    for EXAMPLE_GRAPH_STEPS steps (every metric, parameter and RMSProp
    leaf bitwise, one capture, K1 once a step), and the lagged actors
    (``_lagged_actor``)."""
    import copy

    import torch

    from repro_torch.examples import vtrace_ablation as ablation
    args = ablation._parser().parse_args(ABLATION_ARGV)
    rows, lines, launches, cost = _example(ops, ablation.main, ABLATION_ARGV)
    want = _launches(vtrace=4 * args.steps * args.seeds)
    arms = [dict(arm=r["arm"], lag=r["lag"], rewards=r["rewards"],
                 ms_per_step=r["seconds"] / (args.steps * args.seeds) * 1e3)
            for r in rows]
    with cudnn_deterministic():
        source, graph, agent, opt = ablation.build(False, args.lag,
                                                   args.steps, lr=args.lr)
        batches = [source.next_batch(agent)
                   for _ in range(EXAMPLE_GRAPH_STEPS)]
        seen = ablation.uncorrected(lambda p, o, s, b: b)(agent, None, 0,
                                                          batches[0])
        log_rho = ablation.log_rhos(agent, seen)
        rho_exact = bool(torch.equal(log_rho, torch.zeros_like(log_rho)))
        eager = copy.deepcopy(agent)
        states = {"graph": opt.init(list(agent.parameters())),
                  "eager": opt.init(list(eager.parameters()))}
        gaps, k1 = {}, []
        for step, batch in enumerate(batches):
            before = ops.stats()["vtrace"]
            _, _, got = graph(agent, states["graph"], step, batch)
            k1.append(ops.stats()["vtrace"] - before)
            _, _, plain = graph.step_fn(eager, states["eager"], step, batch)
            _note_tree(gaps, "metrics/", got, plain)
            _note_tree(gaps, "params/", dict(agent.named_parameters()),
                       dict(eager.named_parameters()))
            _note_tree(gaps, "opt_state/", states["graph"], states["eager"])
        lagged = _lagged_actor(ablation, args)
    emit("example_ablation", argv=ABLATION_ARGV, steps=args.steps,
         lag=args.lag, arms=arms, csv=lines, launches=launches,
         want_launches=want, uncorrected_log_rho_max=float(
             log_rho.abs().max()), uncorrected_log_rho_exact=rho_exact,
         graph_steps=EXAMPLE_GRAPH_STEPS, products=len(gaps),
         gaps={k: v for k, v in gaps.items() if v},
         captures=graph.captures, graph_vtrace_launches=k1,
         lagged_actor=lagged, **cost)
    if not all(math.isfinite(r) for a in arms for r in a["rewards"]):
        raise AssertionError(f"example_ablation: rewards {arms}")
    _exact("example_ablation", launches, want)
    _check_bitwise("example_ablation uncorrected step", gaps)
    if not rho_exact or graph.captures != 1 \
            or k1 != [1] * EXAMPLE_GRAPH_STEPS:
        raise AssertionError(f"example_ablation: log rho exact {rho_exact}, "
                             f"captures {graph.captures}, K1 {k1}")
    if any(lagged["actor_gaps"]) or any(lagged["logit_gaps"]) \
            or not all(lagged["learner_differs_between_syncs"]):
        raise AssertionError(f"example_ablation: lagged actors {lagged}")
    return launches


def phase_example_gridworld(ops):
    """34c: ``minatar_gridworld.main(GRIDWORLD_ARGV)``: the fused unroll and
    learner step (``compiled.UnrollTrainStep``, one capture; K1 once a
    step), the reference's fps lines; then, cuDNN pinned deterministic,
    the fused graph against the plain unroll-then-step from one state
    (``build`` twice from the seeds) for EXAMPLE_GRAPH_STEPS steps: every
    metric, parameter, RMSProp leaf, the env carry and the generator's
    state bitwise, one capture, K1 once a step; then ms a step, eager and
    graph in turns."""
    import torch

    from repro_torch.examples import minatar_gridworld as gridworld
    steps = int(_arg(GRIDWORLD_ARGV, "--steps"))
    out, lines, launches, cost = _example(ops, gridworld.main,
                                          GRIDWORLD_ARGV)
    want = _launches(vtrace=steps)
    with cudnn_deterministic():
        graph, agent, state, _ = gridworld.build(steps)
        plain, eager, estate, _ = gridworld.build(steps)
        gaps, k1 = {}, []
        for step in range(EXAMPLE_GRAPH_STEPS):
            before = ops.stats()["vtrace"]
            _, _, got = graph(agent, state, step)
            k1.append(ops.stats()["vtrace"] - before)
            _, _, want_m = plain.step(eager, estate, step)
            _note_tree(gaps, "metrics/", got, want_m)
            _note_tree(gaps, "params/", dict(agent.named_parameters()),
                       dict(eager.named_parameters()))
            _note_tree(gaps, "opt_state/", state, estate)
            _note_tree(gaps, "carry/", graph.unroll.carry,
                       plain.unroll.carry)
            _note_tree(gaps, "generator/",
                       graph.unroll.generator.get_state(),
                       plain.unroll.generator.get_state())
        ms = _alternated_ms({
            "eager": lambda: plain.step(eager, estate, steps),
            "graph": lambda: graph(agent, state, steps)}, GRAPH_TIMED)
    last = out["lines"][-1]
    emit("example_gridworld", argv=GRIDWORLD_ARGV, fps=last["fps"],
         final_reward_per_step=last["reward_per_step"], printed=out["lines"],
         ms_per_step=out["seconds"] / steps * 1e3, captures=out["captures"],
         launches=launches, want_launches=want,
         graph_steps=EXAMPLE_GRAPH_STEPS, products=len(gaps),
         gaps={k: v for k, v in gaps.items() if v},
         check_captures=graph.captures, graph_vtrace_launches=k1,
         eager_ms_per_step=ms["eager"], graph_ms_per_step=ms["graph"],
         **cost)
    if not all(math.isfinite(ln["reward_per_step"]) for ln in out["lines"]):
        raise AssertionError(f"example_gridworld: {out['lines']}")
    _exact("example_gridworld", launches, want)
    _check_bitwise("example_gridworld fused step", gaps)
    if out["captures"] != 1 or graph.captures != 1 \
            or k1 != [1] * EXAMPLE_GRAPH_STEPS:
        raise AssertionError(f"example_gridworld: captures {out['captures']}"
                             f", {graph.captures}, K1 {k1}")
    del graph, plain, agent, eager, state, estate
    torch.cuda.empty_cache()
    return launches


def phase_example_lm_rl(ops):
    """34d: ``lm_rl_100m.main(LM_RL_100M_ARGV)`` at its default width
    (94,723,328 parameters at vocab 512; d 640, 16 layers) with vocab 256,
    100 steps of B 32 episodes of 32 tokens: every step's reward (the
    curve), K1 once a step, K2 once a layer in each step's prefill and its
    learner forward (no remat), K3 once a layer a decode step (31 a step);
    then from a fresh build (weights from seed 0, twice), one generated
    batch rotated along the batch for each of EXAMPLE_GRAPH_STEPS steps:
    the learner's graph against its plain step, every metric, parameter
    and AdamW leaf bitwise, one capture, K1 1 and K2 one a layer a step;
    generation and learner ms a step (synchronised medians)."""
    import statistics as stats

    import torch

    from repro_torch.core import generate as gen_lib
    from repro_torch.examples import lm_rl_100m
    from repro_torch.models import model as model_lib
    args = lm_rl_100m._parser().parse_args(LM_RL_100M_ARGV)
    out, lines, launches, cost = _example(ops, lm_rl_100m.main,
                                          LM_RL_100M_ARGV)
    layers, decode_steps = args.layers, args.ep_len - 1
    want = _launches(vtrace=args.steps,
                     flash_attention=2 * layers * args.steps,
                     decode_attention=decode_steps * layers * args.steps)
    rewards = out["rewards"]
    reached = next((i for i, r in enumerate(rewards) if r >= 0.5), None)

    cfg, _, params, opt, state, graph = lm_rl_100m.build(args)
    eager = model_lib.init(cfg, seed=0, device="cuda")
    estate = opt.init(list(eager.parameters()))
    start_gaps = {}
    _note_tree(start_gaps, "", dict(params.named_parameters()),
               dict(eager.named_parameters()))
    gen = torch.Generator().manual_seed(7)
    prompt, seed = lm_rl_100m.draw(gen, args, cfg.vocab_size)

    def generate():
        return gen_lib.generate(params, prompt, seed, cfg=cfg,
                                num_steps=args.ep_len)

    def timed(fn, reps):
        times, res = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return res, times

    before = ops.stats()
    ep, gen_ms = timed(generate, 5)
    gen_launches = {k: (v - before[k]) // 5 for k, v in ops.stats().items()}
    first = lm_rl_100m.episode_batch(ep, cfg.vocab_size)
    batches = [{k: v.roll(i, dims=0) for k, v in first.items()}
               for i in range(EXAMPLE_GRAPH_STEPS)]
    gaps, step_launches, ms = {}, [], {"graph": [], "eager": []}
    for step, batch in enumerate(batches):
        before = ops.stats()
        (_, _, got), t = timed(lambda: graph(params, state, step, batch), 1)
        step_launches.append({k: v - before[k]
                              for k, v in ops.stats().items()})
        ms["graph"] += t
        (_, _, plain), t = timed(
            lambda: graph.step_fn(eager, estate, step, batch), 1)
        ms["eager"] += t
        _note_tree(gaps, f"metrics/{step}/", got, plain)
    _note_tree(gaps, "params/", dict(params.named_parameters()),
               dict(eager.named_parameters()))
    _note_tree(gaps, "opt_state/", state, estate)
    step_want = _launches(vtrace=1, flash_attention=layers)
    emit("example_lm_rl_100m", argv=LM_RL_100M_ARGV, params=out["params"],
         d_model=args.d_model, layers=layers, vocab=args.vocab,
         batch=args.batch, ep_len=args.ep_len, steps=args.steps,
         run_seconds=out["seconds"],
         ms_per_step=out["seconds"] / args.steps * 1e3,
         tok_s=args.steps * args.batch * args.ep_len / out["seconds"],
         rewards=rewards, first_step_at_0_5=reached, printed=out["lines"],
         launches=launches, want_launches=want,
         generation_ms=stats.median(gen_ms[2:]), generation_ms_all=gen_ms,
         generation_launches=gen_launches,
         learner_graph_ms=ms["graph"][-1],
         learner_eager_ms=stats.median(ms["eager"][1:]), learner_ms=ms,
         graph_steps=EXAMPLE_GRAPH_STEPS, products=len(gaps),
         start_gaps=max(start_gaps.values()),
         gaps={k: v for k, v in gaps.items() if v}, captures=graph.captures,
         graph_step_launches=step_launches, **cost)
    if not all(math.isfinite(r) for r in rewards) \
            or len(rewards) != args.steps:
        raise AssertionError(f"example_lm_rl_100m: rewards {rewards}")
    _exact("example_lm_rl_100m", launches, want)
    _check_bitwise("example_lm_rl_100m start", start_gaps)
    _check_bitwise("example_lm_rl_100m learner step", gaps)
    if graph.captures != 1 or any(s != step_want for s in step_launches):
        raise AssertionError(f"example_lm_rl_100m: captures "
                             f"{graph.captures}, step launches "
                             f"{step_launches}, want {step_want}")
    del params, eager, state, estate, graph, batches, first, ep
    torch.cuda.empty_cache()
    return launches


def phase_example_serve(ops):
    """34e: ``serve_batched.main(SERVE_BATCHED_ARGV)``: its
    DeprecationWarning, then the reduced server it forwards to: every
    request served and echoed, K2 once an attention layer an admission
    and K3 once a decode step."""
    import warnings

    from repro_torch.configs import get_reduced_config
    from repro_torch.examples import serve_batched
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        summary, lines, launches, cost = _example(
            ops, serve_batched.main, SERVE_BATCHED_ARGV)
    deprecated = any(issubclass(w.category, DeprecationWarning)
                     for w in caught)
    attn, mamba = kernel_layers(get_reduced_config(
        _arg(SERVE_BATCHED_ARGV, "--arch")))
    want = _launches(flash_attention=attn * summary["admissions"],
                     ssd_chunk=mamba * summary["admissions"],
                     decode_attention=attn * summary["steps"])
    emit("example_serve_batched", argv=SERVE_BATCHED_ARGV,
         deprecation_warned=deprecated, launches=launches,
         want_launches=want, peak_mem_bytes=cost["peak_mem_bytes"],
         **summary)
    if not deprecated or summary["served"] != summary["requests"] \
            or not summary["prompt_echo_ok"] or not summary["steps"]:
        raise AssertionError(f"example_serve_batched: warned {deprecated}, "
                             f"{summary}")
    _exact("example_serve_batched", launches, want)
    return launches


def phase34(ops):
    """34: the five examples on the card (34a-34e). Returns each one's
    launches."""
    t0 = time.perf_counter()
    out = {"example_quickstart": phase_example_quickstart(ops),
           "example_ablation": phase_example_ablation(ops),
           "example_gridworld": phase_example_gridworld(ops),
           "example_lm_rl_100m": phase_example_lm_rl(ops),
           "example_serve_batched": phase_example_serve(ops)}
    emit("examples", seconds=time.perf_counter() - t0)
    return out


def phase3(ops, ref):
    """3: each kernel against its plain version. Returns the rows of K1,
    K2, K2 at a query offset, K3 and K4."""
    import torch
    rows = (phase_kernel(ops, ref), phase_flash(ops, ref),
            phase_flash_offset(ops, ref), phase_decode(ops, ref),
            phase_ssd(ops, ref))
    # SDPA's graph captures left cuBLAS a workspace on each capture
    # stream; free them so that later phases' peak memory leaves them out
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return rows


def main(argv=None):
    """The whole smoke test; ``--phase N`` (3, 32, 33 or 34, repeatable) runs
    phases 1, 2 and those alone and prints no result line."""
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", action="append",
                        choices=["3", "32", "33", "34"], default=[])
    alone = parser.parse_args(argv).phase
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

    # 2. build: one nvcc per source, all started together; V-trace's
    # chunks live in registers, so a spill there fails the build phase
    t0 = time.perf_counter()
    for name, r in build.build_all().items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        spill_bytes = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", r["log"]))
        emit("build", kernel=name, seconds=r["seconds"], ptxas=ptxas,
             spill_bytes=spill_bytes)
        if name == "vtrace" and spill_bytes:
            raise AssertionError(f"vtrace kernel spills {spill_bytes} bytes")
    emit("build", total_seconds=time.perf_counter() - t0)
    # 2b. the launch geometry's Python mirrors against the built .cu
    phase_geometry(ops)

    if alone:
        if "3" in alone:
            phase3(ops, ref)
        if "32" in alone:
            phase32(ops)
        if "33" in alone:
            phase33(ops)
        if "34" in alone:
            phase34(ops)
        print(smi, flush=True)
        return 0

    # 3. each kernel against its plain version
    rows, flash_rows, offset_rows, decode_rows, ssd_rows = phase3(ops, ref)

    # 33. slice 20: the families of phase 32 trained through the entry
    # point at every published width (lm-rl and lm, depth cut as
    # FAMILY_TRAIN), each run's float32 kernel-against-plain step and its
    # learner graph against eager. It runs here, before phase 4: its 50-58
    # GB states and their graph pools need a card that no earlier phase
    # has left memory on (after phase 32, 2.7 GB still allocated and 8.4
    # reserved, Gemma2's lm-rl graph capture ran out of memory)
    slice20 = phase33(ops)

    # 4. full-width learner, then on replay's mixed batches (4b)
    phase_learner(ops)
    replay_learner_launches = phase_replay_learner(ops)

    # 5. the trainer through its entry point: the rl-agent main path
    ops.reset_stats()
    runtime, seconds, last = run_trainer(TRAINER_ARGV)
    trainer_launches = ops.stats()
    trainer_chunks = ops.last_vtrace_chunks()
    if trainer_launches["vtrace"] < 20:
        raise AssertionError(f"trainer made {trainer_launches} vtrace "
                             "launches, fewer than its 20 steps")
    loss = float(runtime.metrics["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"trainer loss not finite: {loss}")
    trainer = dict(env="gridworld", agent="deep", T=TRAINER_SHAPE[0],
                   B=TRAINER_SHAPE[1], steps=20, seconds=seconds,
                   ms_per_step=seconds / 20 * 1e3, launches=trainer_launches,
                   vtrace_chunks=list(trainer_chunks), fps_line=last,
                   **split_ms(runtime)[0])
    emit("trainer", **trainer)

    # 5b. the same run with --replay elite, and the overlap check
    replay_launches = phase_replay_trainer(ops, trainer)

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
         **split_ms(runtime)[0])
    if not final > 0.05:
        raise AssertionError(f"Catch not solved: reward/step {final:+.3f}")
    del runtime
    torch.cuda.empty_cache()

    # 6b. the reference's replay example (no solve is claimed at 500 steps)
    before = ops.stats()["vtrace"]
    runtime, seconds, last = run_trainer(REPLAY_EXAMPLE_ARGV)
    final = float(runtime.metrics["reward_per_step"])
    if not math.isfinite(final):
        raise AssertionError(f"replay example reward/step {final}")
    emit("replay_example", argv=REPLAY_EXAMPLE_ARGV, seconds=seconds,
         ms_per_step=seconds / 500 * 1e3,
         vtrace_launches=ops.stats()["vtrace"] - before,
         final_reward_per_step=final, fps_line=last)
    del runtime
    torch.cuda.empty_cache()

    # 7. the host actors through the entry point, then with replay (7b)
    host = phase_host(ops)
    host_launches = host["launches"]
    replay_host_launches = phase_replay_host(ops, host)

    # 8. checkpoint and resume, bitwise; then with replay (8b)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
        phase_resume(ops, workdir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
        phase_resume(ops, workdir, RESUME_REPLAY_ARGV)

    # 9. full-width Qwen3-4B: kernel path against the dense path
    phase_model(ops, "qwen3-4b", 300)

    # 10. the server through its entry point: the serving main path, then
    # a profile of its decode step
    serve_launches = phase_serve(ops, SERVE_ARGV)
    torch.cuda.empty_cache()
    phase_profile("qwen3-4b", [256 + 32 * slot for slot in range(8)], 576,
                  PROFILE_GROUPS["qwen3-4b"])

    # 11. full-width Zamba2-2.7B: kernel path against the plain path
    phase_model(ops, "zamba2-2.7b", 512)

    # 12. the Zamba2 server: the path through the SSD chunk kernel, then a
    # profile of its decode step and of one admission
    zamba_launches = phase_serve(ops, ZAMBA_SERVE_ARGV)
    torch.cuda.empty_cache()
    phase_profile("zamba2-2.7b", [32 * (slot + 1) for slot in range(8)],
                  320, PROFILE_GROUPS["zamba2-2.7b"])

    # 13. gradients on the card: the kernel paths against the plain paths
    phase_grad(ops)

    # 15. LLM-policy IMPALA at full Qwen3-4B width (K1, K2, K3); 16. LM
    # pretraining at full Zamba2-2.7B width (K4, K2)
    lm_rl_launches = phase_lm_rl(ops)
    lm_launches = phase_lm(ops)

    # 17. data parallel (--mesh-data): 17a world size 1 through NCCL, 17b
    # two ranks sharing the card through gloo, 17c the trainer's runs
    # with --mesh-data 1, 17d its resume
    dp = phase_dp(ops)
    dp2_launches = phase_dp2(dp)
    dp_trainer_launches = phase_dp_trainer(ops)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as workdir:
        dp_resume_launches = phase_dp_resume(ops, workdir)

    # 18. the recurrent agent: Catch unroll + learner, then full width
    recurrent_launches = phase_recurrent(ops)

    # 19. full-width Granite-3.0-1B-A400M: kernel path against the plain
    # path, routing included; 20. its server; 21. its lm-rl and lm runs
    phase_model(ops, GRANITE, 256, phase="granite")
    gserve_launches = phase_gserve(ops)
    glm_rl_launches = phase_lm_rl(ops, GLM_RL_ARGV, phase="glm_rl")
    glm_launches = phase_lm(ops, GLM_ARGV, phase="glm")

    # 22. full-width xLSTM-125M: forward against prefill + decode, and
    # chunkwise mLSTM against its sequential oracle; 23. its server; 24.
    # its lm-rl (K1) and lm runs
    phase_xlstm(ops)
    phase_serve(ops, XSERVE_ARGV, phase="xserve")
    torch.cuda.empty_cache()
    phase_profile(XLSTM, [8 * (slot + 1) for slot in range(8)], 128,
                  PROFILE_GROUPS[XLSTM])
    xlm_rl_launches = phase_lm_rl(ops, XLM_RL_ARGV, phase="xlm_rl")
    phase_lm(ops, XLM_ARGV, phase="xlm")

    # 25. Llama-3.2-Vision-90B, one group at full width: float32 kernel
    # path against the plain path, bf16 generate(vision=), reduced lm
    vlm_generate_launches, vlm_lm_launches = phase_vlm(ops)

    # 26. model parallel, ranks sharing the card through gloo: 26a
    # Zamba2-2.7B --mode lm, 26b Granite lm-rl, 26c reduced (2, 2), 26d
    # checkpoints (kill and resume, elastic restores)
    zmp_launches = phase_mp(ZMP_ARGV, MP_F32_GROUPS["zamba2-2.7b"], "mp_lm")
    gmp_launches = phase_mp(GMP_ARGV, MP_F32_GROUPS[GRANITE], "mp_lm_rl")
    phase_mp22()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as workdir:
        phase_mp_checkpoint(workdir)

    # 27. the model axis for the xLSTM mixers and xattn, the other rules
    # tables: 27a xLSTM-125M at (1, 2) (lm-rl, lm, the server), 27b one
    # Llama-3.2-Vision-90B group at (1, 2), 27c the specs programs, 27d the
    # multihost entry point
    spec_launches = phase27()

    # 28. slice 15: 28a --mode rl-agent as two --coordinator processes on
    # the card, 28b the context-parallel specs program (K2 with its query
    # offset), 28c the dry run
    slice15 = phase28()

    # 29. slice 16: the compiled decode step at full width (the servers'
    # sessions, one VLM group's generate, Granite's lm-rl generation),
    # graph against eager
    phase29(ops)

    # 30. slice 17: the rl-agent learner steps (deep and recurrent, full
    # width), the device actors' unroll (gridworld, Catch) and the
    # admissions (Qwen3-4B, Zamba2-2.7B) as CUDA graphs against eager
    slice17 = phase30(ops)

    # 31. slice 18: the LM learner steps at full width (Qwen3-4B and
    # Granite lm-rl, Zamba2-2.7B, xLSTM-125M and the reduced VLM lm) and
    # replay's value function as CUDA graphs against eager (31b, the host
    # actors' policy: phase 7's run; 31d, the VLM's prefill: phase 29)
    slice18 = phase31(ops)

    # 32. slice 19: Gemma2-27B, Mixtral-8x7B, DeepSeek-Coder-33B and
    # MusicGen-Large, float32 kernel path against the plain path (32a),
    # then served, with their compiled decode steps against eager (32b)
    slice19 = phase32(ops)

    # 34. slice 21: the repository's examples on the port (quickstart, the
    # V-trace ablation, the gridworld's fused step, lm_rl_100m at its
    # default width, serve_batched), each through its main, and the graphs
    # they capture against eager
    slice21 = phase34(ops)

    # 14. kernels, card, result
    row = rows[TRAINER_SHAPE]
    replay_row = rows[REPLAY_SHAPE]
    lm_rl_row = rows[LM_RL_SHAPE]
    kernels = [{
        "name": "vtrace", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/vtrace.cu",
        "replaces": "src/repro/kernels/vtrace.py:38",
        "launches": trainer_launches["vtrace"],
        "host_launches": host_launches["vtrace"],
        "replay_launches": replay_launches,
        "replay_host_launches": replay_host_launches,
        "replay_learner_launches": replay_learner_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "graph_ms": row["graph_ms"],
        "bound_share": row["bound_share"],
        "host_loop_us": row["host_loop_us"],
        "floor_graph_ms": rows[VTRACE_FLOOR]["graph_ms"],
        "chunks": list(trainer_chunks),
        "shape": list(TRAINER_SHAPE),
        "replay_shape": list(REPLAY_SHAPE),
        "replay_ms": replay_row["ms"], "replay_plain_ms":
        replay_row["plain_ms"], "replay_graph_ms": replay_row["graph_ms"],
        "replay_bound_ms": replay_row["bound_ms"],
        "replay_bound_by": replay_row["bound_by"],
        "replay_bound_share": replay_row["bound_share"],
        "lm_rl_launches": lm_rl_launches["vtrace"],
        "lm_rl_shape": list(LM_RL_SHAPE), "lm_rl_ms": lm_rl_row["ms"],
        "lm_rl_plain_ms": lm_rl_row["plain_ms"],
        "lm_rl_graph_ms": lm_rl_row["graph_ms"],
        "lm_rl_bound_ms": lm_rl_row["bound_ms"],
        "lm_rl_bound_by": lm_rl_row["bound_by"],
        "lm_rl_bound_share": lm_rl_row["bound_share"],
        "dp_launches": dp["launches"], "dp_shape": list(DP_SHAPE),
        "dp2_launches": dp2_launches, "dp2_shape": list(DP2_SHAPE),
        "dp_trainer_launches": dp_trainer_launches["trainer"],
        "dp_replay_launches": dp_trainer_launches["replay"],
        "dp_host_launches": dp_trainer_launches["host"],
        "dp_resume_launches": dp_resume_launches,
        "recurrent_launches": recurrent_launches["catch"]["launches"],
        "recurrent_shape": recurrent_launches["catch"]["shape"],
        "recurrent_full_launches":
        recurrent_launches["full_width"]["launches"],
        "recurrent_full_shape": recurrent_launches["full_width"]["shape"],
        "granite_lm_rl_launches": glm_rl_launches["vtrace"],
        "xlstm_lm_rl_launches": xlm_rl_launches["vtrace"],
        "mp_lm_rl_launches": [r["vtrace"] for r in gmp_launches]}]
    for name, replaces, all_rows, (shape, dtype) in [
            ("flash_attention", "src/repro/kernels/flash_attention.py:93",
             flash_rows, FLASH_MAIN),
            ("decode_attention", "src/repro/kernels/decode_attention.py:75",
             decode_rows, DECODE_MAIN)]:
        row = all_rows[(shape, dtype)]
        errs = {d: max(r["max_abs_err"] for (_, rd), r in all_rows.items()
                       if rd == d) for d in ("bfloat16", "float32")}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": serve_launches[name],
            "lm_rl_launches": lm_rl_launches[name],
            **({"lm_launches": lm_launches[name],
                "granite_lm_launches": glm_launches[name]}
               if name == "flash_attention" else {}),
            "granite_serve_launches": gserve_launches[name],
            "granite_lm_rl_launches": glm_rl_launches[name],
            "vlm_generate_launches": vlm_generate_launches[name],
            "mp_lm_rl_launches": [r[name] for r in gmp_launches],
            **({"mp_lm_launches": [r[name] for r in zmp_launches]}
               if name == "flash_attention" else {}),
            **({"vlm_lm_launches": vlm_lm_launches[name]}
               if name == "flash_attention" else {}),
            "max_abs_err": max(errs.values()),
            "max_abs_err_bf16": errs["bfloat16"],
            "max_abs_err_f32": errs["float32"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "graph_ms": row["graph_ms"],
            "library_graph_ms": row["library_graph_ms"],
            "bound_share": row["bound_share"],
            "host_loop_us": row["host_loop_us"],
            **({"splits": row["splits"]} if "splits" in row else {}),
            "shape": row["shape"], "dtype": dtype})
    row = ssd_rows[SSD_MAIN]
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:68",
        "launches": zamba_launches["ssd_chunk"],
        "lm_launches": lm_launches["ssd_chunk"],
        "mp_lm_launches": [r["ssd_chunk"] for r in zmp_launches],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "graph_ms": row["graph_ms"],
        "bound_share": row["bound_share"],
        "host_loop_us": row["host_loop_us"],
        "tc_bound_ms": row["tc_bound_ms"], "tc_bound_by": row["tc_bound_by"],
        "shape": row["shape"], "heads": row["heads"], "dtype": "float32"})
    for k in kernels:
        # phase 27's and 28's launches a rank, run by run
        k["slice14_launches"] = {phase: launches[k["name"]]
                                 for phase, launches in spec_launches.items()}
        k["slice15_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice15.items()
            if k["name"] in launches}
        k["slice17_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice17.items()
            if k["name"] in launches}
        k["slice18_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice18.items()
            if k["name"] in launches}
        k["slice19_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice19.items()}
        k["slice20_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice20.items()}
        k["slice21_launches"] = {
            phase: launches[k["name"]] for phase, launches in slice21.items()}
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    row = offset_rows[(FLASH_OFFSET_SHAPES[0], "bfloat16")]
    flash.update(offset_shape=list(FLASH_OFFSET_SHAPES[0]),
                 offset_ms=row["ms"], offset_plain_ms=row["plain_ms"],
                 offset_graph_ms=row["graph_ms"],
                 offset_bound_ms=row["bound_ms"],
                 offset_bound_by=row["bound_by"],
                 offset_library_ms=row["library_ms"],
                 offset_max_abs_err=max(
                     r["max_abs_err"] for r in offset_rows.values()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

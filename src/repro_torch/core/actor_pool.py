"""Host-loop actor pool — the MonoBeast/PolyBeast actor architecture in
Python threads.

Each actor thread runs its environment copy (``envs.base.HostEnv``),
sends observations through the shared DynamicBatcher (the inference
queue; evaluated centrally in batch), accumulates unroll_length
transitions, and puts the rollout into the BatchingQueue (the learner
queue). An inference thread drains the DynamicBatcher with the policy —
mirroring polybeast.py's ``inference_thread`` — and the learner iterates
the BatchingQueue.

Actions are drawn on the actor by Gumbel-max from
``np.random.default_rng(seed + idx)``, as the reference draws them, so
given the same env and policy the actor loop is bitwise the reference's.

This path exists for environments that cannot run on the device (the
paper's Atari case). The on-device alternative is core/rollout.py.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.batcher import BatchingQueue, Closed, DynamicBatcher


class ActorPool:
    def __init__(self, env_fn: Callable[[int], object], num_actors: int,
                 unroll_length: int, inference: DynamicBatcher,
                 learner_queue: BatchingQueue, seed: int = 0):
        self.env_fn = env_fn
        self.num_actors = num_actors
        self.unroll_length = unroll_length
        self.inference = inference
        self.learner_queue = learner_queue
        self.seed = seed
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.steps = 0  # total env frames (for FPS accounting)
        self._steps_lock = threading.Lock()

    def _actor_loop(self, idx: int):
        env = self.env_fn(self.seed + idx)
        rng = np.random.default_rng(self.seed + idx)
        obs = env.reset()
        try:
            while not self._stop.is_set():
                traj = {"obs": [obs], "action": [], "behavior_logits": [],
                        "reward": [], "done": []}
                for _ in range(self.unroll_length):
                    logits = self.inference.compute(
                        np.asarray(obs, np.float32))
                    # sample on the actor (host) side via Gumbel-max
                    u = rng.gumbel(size=logits.shape)
                    action = int(np.argmax(logits + u))
                    obs, reward, done, _ = env.step(action)
                    traj["obs"].append(obs)
                    traj["action"].append(action)
                    traj["behavior_logits"].append(logits)
                    traj["reward"].append(reward)
                    traj["done"].append(done)
                rollout = {
                    "obs": np.stack(traj["obs"]).astype(np.float32),
                    "action": np.asarray(traj["action"], np.int32),
                    "behavior_logits": np.stack(traj["behavior_logits"]),
                    "reward": np.asarray(traj["reward"], np.float32),
                    "done": np.asarray(traj["done"], bool),
                }
                self.learner_queue.put(rollout)
                with self._steps_lock:
                    self.steps += self.unroll_length
        except Closed:
            pass

    def start(self):
        for i in range(self.num_actors):
            t = threading.Thread(target=self._actor_loop, args=(i,),
                                 daemon=True, name=f"actor-{i}")
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        self.inference.close()
        self.learner_queue.close()
        for t in self._threads:
            t.join(timeout=5.0)


def start_inference_thread(batcher: DynamicBatcher, policy_fn,
                           device: Optional[torch.device] = None,
                           ) -> threading.Thread:
    """polybeast.py's ``infer``: drain the inference queue with the
    policy. policy_fn: (B, *obs) -> (B, A) logits, numpy in and out.

    Autograd mode and the current CUDA device are per thread, so the
    thread sets both itself: no autograd, and ``device`` current when it
    is a CUDA device."""
    def loop():
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            while True:
                try:
                    got = batcher.get_batch(timeout=1.0)
                except Closed:
                    return
                if got is None:
                    continue
                obs, respond, _ = got
                respond(np.asarray(policy_fn(obs)))

    t = threading.Thread(target=loop, daemon=True, name="inference")
    t.start()
    return t

"""Continuous-batching inference server on the DecodeSession API.

The PolyBeast inference-queue idea (keep accelerator evaluations batched)
taken to its serving conclusion: instead of draining fixed batches and
running each to completion (head-of-line blocking on the longest
generation), the server owns one ``core.generate.DecodeSession`` and
re-decides the batch every step — finished requests are evicted and
queued requests admitted into the freed slots while the survivors keep
decoding. ``--policy static`` keeps drain-and-run as a baseline.

Client API (request handles, not blocking arrays):

    h = server.submit(prompt, max_tokens=64, temperature=0.8,
                      stop_token=eos, seed=7)
    tokens = h.result(timeout=30)     # (P + generated,) int32

A single-request server is bitwise-identical to ``core.generate.generate``
with the same seed (tests/test_torch_serve.py).

Runs on CUDA unless ``--device cpu`` is given; with ``--attn-impl kernel``
every prefill runs the flash-attention kernel and every decode step the
decode-attention kernel, and with ``--ssd-impl kernel`` every Mamba2
prefill runs the SSD chunk kernel (Zamba2: prompts of at most
``ssm_chunk`` tokens, 256 at full width, or a multiple of it, as in the
reference). An xLSTM server (no kernel: the mLSTM and sLSTM mixers are
plain PyTorch) likewise takes prompts of at most ``xlstm_chunk`` tokens,
64 at full width, or a multiple of it. A VLM is refused, as in the
reference: its rollouts run through ``core.generate.generate(vision=)``.
Weights are initialised from seed 0:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --attn-impl kernel --requests 24 --prompt-len 512 --gen-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --attn-impl kernel --ssd-impl kernel --requests 24 --prompt-len 256 \\
      --gen-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --reduced --device cpu --requests 6 --gen-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --requests 24 --prompt-len 64 --gen-tokens 64
"""

from __future__ import annotations

import argparse
import collections
import statistics
import sys
import threading
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ImplContext
from repro_torch.core.generate import DecodeSession
from repro_torch.models import model as model_lib


class RequestHandle:
    """Future-style handle for one submitted request."""

    def __init__(self, prompt: np.ndarray):
        self.prompt = prompt
        self._event = threading.Event()
        self._tokens = None
        self._error = None
        self.t_submit = time.monotonic()
        self.t_first = None           # first generated token (prefill done)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until complete; returns (P + generated,) int32 tokens
        (prompt echoed, stop token included when hit)."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not complete")
        if self._error is not None:
            raise self._error
        return self._tokens

    # -- server side --------------------------------------------------------

    def _complete(self, tokens: np.ndarray) -> None:
        self._tokens = tokens
        self._event.set()

    def _fail(self, err: Exception) -> None:
        self._error = err
        self._event.set()


class _Request:
    __slots__ = ("handle", "prompt", "max_tokens", "temperature",
                 "stop_token", "seed", "tokens", "slot")

    def __init__(self, handle, prompt, max_tokens, temperature, stop_token,
                 seed):
        self.handle = handle
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.temperature = temperature
        self.stop_token = stop_token
        self.seed = seed
        self.tokens: list = []


class Server:
    """Continuous-batching server over one DecodeSession, on the device of
    ``params``. Its own thread drives the device.

    policy='continuous': admission/eviction every step (default).
    policy='static':     admit only into an EMPTY batch and run it until
                         every member finishes — the fixed-batch baseline.

    Counters for the serving metrics: ``served``, ``steps`` (decode steps),
    ``tokens_out`` (generated tokens, prefill's included), ``admissions``,
    and the host-clock seconds spent in admissions (``prefill_seconds``)
    and decode steps (``decode_seconds``); both end in a copy of the
    sampled tokens to the host, so they include the device's work.

    ``mesh``, ``rules``: a model-parallel rank's ``Mesh2D`` and rules
    (``params`` its slices), passed to the session. Each rank of a model
    group runs its own server, and they stay in lockstep only if every
    one of them admits the same requests at the same steps: submit them
    all before the loop takes the first (``policy='static'`` then admits
    one batch and runs it out on every rank alike).
    """

    def __init__(self, cfg, params, *, max_batch: int = 8,
                 max_len: int = 256, policy: str = "continuous",
                 default_max_tokens: int = 16, seed: int = 0, mesh=None,
                 rules=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        self.cfg = cfg
        self.policy = policy
        self.default_max_tokens = default_max_tokens
        self.session = DecodeSession(params, cfg, max_batch=max_batch,
                                     max_len=max_len, mesh=mesh, rules=rules)
        self._rng = np.random.default_rng(seed)
        self._cv = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._inflight: dict = {}     # slot -> _Request
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.served = 0
        self.steps = 0
        self.tokens_out = 0
        self.admissions = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def start(self) -> "Server":
        self._thread.start()
        return self

    def stop(self, timeout: float = 60) -> None:
        """Close the queue and join the server thread; in-flight and queued
        requests still complete first."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"server thread still running after "
                               f"{timeout} s")

    def submit(self, prompt, *, max_tokens: int | None = None,
               temperature: float = 1.0, stop_token: int | None = None,
               seed: int | None = None) -> RequestHandle:
        """Enqueue a request (any thread). ``seed`` pins the request's
        sampling generator (parity tests); None draws one from the
        server's own stream."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 0 < prompt.shape[0] < self.session.max_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} not in "
                f"[1, {self.session.max_len})")
        handle = RequestHandle(prompt)
        n = max_tokens if max_tokens is not None else self.default_max_tokens
        n = min(n, self.session.max_len - prompt.shape[0])
        with self._cv:
            if self._closed:
                raise RuntimeError("server is stopped")
            if seed is None:
                seed = int(self._rng.integers(2 ** 62))
            self._queue.append(_Request(handle, prompt, n, temperature,
                                        stop_token, int(seed)))
            self._cv.notify()
        return handle

    # -- server thread ------------------------------------------------------

    def _free_slot(self):
        """First slot neither active nor reserved by a pending admission."""
        active = self.session.active
        for s in range(self.session.max_batch):
            if not active[s] and s not in self._inflight:
                return s
        return None

    def _admissible(self) -> bool:
        if not self._queue or self._free_slot() is None:
            return False
        return self.policy == "continuous" or not self._inflight

    def _finish(self, slot: int) -> None:
        req = self._inflight.pop(slot)
        self.session.evict(slot)
        req.handle._complete(np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)]))
        self.served += 1

    def _took(self, slot: int, token: int) -> None:
        """Record one generated token; finish the request on stop/budget."""
        req = self._inflight[slot]
        req.tokens.append(token)
        self.tokens_out += 1
        if req.handle.t_first is None:
            req.handle.t_first = time.monotonic()
        if token == req.stop_token or len(req.tokens) >= req.max_tokens:
            self._finish(slot)

    def _loop(self) -> None:
        while True:
            reqs = []
            with self._cv:
                while (not self._closed and not self._queue
                       and not self._inflight):
                    self._cv.wait(timeout=0.5)
                if (self._closed and not self._queue
                        and not self._inflight):
                    return
                while self._admissible():
                    # reserve the slot now so _admissible stays accurate
                    slot = self._free_slot()
                    req = self._queue.popleft()
                    req.slot = slot
                    self._inflight[slot] = req
                    reqs.append(req)
            for req in reqs:   # prefill outside the lock (slow)
                slot = req.slot
                t0 = time.perf_counter()
                try:
                    out = self.session.prefill_into(
                        slot, req.prompt, seed=req.seed,
                        temperature=req.temperature)
                except Exception as e:  # noqa: BLE001 - fails this request
                    self._inflight.pop(slot)
                    req.handle._fail(e)
                    continue
                self.prefill_seconds += time.perf_counter() - t0
                self.admissions += 1
                self._took(slot, int(out["token"]))
            if self._inflight:
                t0 = time.perf_counter()
                try:
                    out = self.session.step()
                except Exception as e:  # noqa: BLE001 - fails the batch
                    for slot in list(self._inflight):
                        self.session.evict(slot)
                        self._inflight.pop(slot).handle._fail(e)
                    continue
                self.decode_seconds += time.perf_counter() - t0
                self.steps += 1
                for slot in list(self._inflight):
                    self._took(slot, int(out["token"][slot]))


def _parser():
    p = argparse.ArgumentParser(
        description="continuous-batching LM server (PyTorch port)")
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--prompt-len", type=int, default=15,
                   help="max prompt length (lengths drawn in [1, this])")
    p.add_argument("--gen-tokens", type=int, default=16,
                   help="max generation budget (per-request budgets drawn "
                        "in [1, this])")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-len", type=int, default=0,
                   help="slot capacity (0: prompt-len + gen-tokens)")
    p.add_argument("--policy", default="continuous",
                   choices=["continuous", "static"])
    p.add_argument("--attn-impl", default=None,
                   choices=["xla", "xla_chunked", "xla_chunked_skip",
                            "kernel"],
                   help="'kernel': the flash-attention kernel for prefill "
                        "and the decode-attention kernel per generated "
                        "token (their plain versions on the CPU); the "
                        "others name plain PyTorch paths")
    p.add_argument("--ssd-impl", default=None, choices=["xla", "kernel"],
                   help="Mamba2 chunk-scan impl for prefill: 'kernel' runs "
                        "the SSD chunk kernel once per chunk (its plain "
                        "version on the CPU), 'xla' the plain einsum path")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run; cuda raises when there is no GPU")
    return p


def main(argv=None) -> dict:
    """Serve ``--requests`` random prompts and print one summary line.
    Returns the summary (counts, seconds, tokens/s, decode ms per step,
    prefill ms per admission, median time to first token); exits 1 if a
    request is not served or does not echo its prompt."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    return run(args, ImplContext.from_args(args).apply(cfg), device)


def run(args, cfg, device) -> dict:
    """``main`` past its flags: serve ``args``' requests from ``cfg`` (a
    config the flags name, or one cut from it, as a full-width model at a
    cut depth) with weights from seed 0 on ``device``."""
    params = model_lib.init(cfg, seed=0, device=device)
    max_len = args.max_len or args.prompt_len + args.gen_tokens
    server = Server(cfg, params, max_batch=args.max_batch, max_len=max_len,
                    policy=args.policy,
                    default_max_tokens=args.gen_tokens).start()

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = []
    try:
        for _ in range(args.requests):
            plen = int(rng.integers(1, args.prompt_len + 1))
            prompt = rng.integers(0, cfg.vocab_size, size=plen)
            handles.append(server.submit(
                prompt,
                max_tokens=int(rng.integers(1, args.gen_tokens + 1))))
        results = [h.result(timeout=600) for h in handles]
        dt = time.perf_counter() - t0
    finally:
        server.stop()

    ok = all(np.array_equal(r[:h.prompt.shape[0]], h.prompt)
             for r, h in zip(results, handles))
    summary = {
        "served": server.served, "requests": args.requests,
        "tokens": server.tokens_out, "steps": server.steps,
        "admissions": server.admissions, "seconds": dt,
        "tokens_per_s": server.tokens_out / dt,
        "decode_ms_per_step": 1e3 * server.decode_seconds
        / max(server.steps, 1),
        "prefill_ms_per_admission": 1e3 * server.prefill_seconds
        / max(server.admissions, 1),
        "ttft_median_s": statistics.median(
            h.t_first - h.t_submit for h in handles),
        "prompt_echo_ok": ok, "device": str(device),
        "policy": args.policy, "attn_impl": cfg.attn_impl,
        "ssd_impl": cfg.ssd_impl, "compiled": server.session.compiled,
    }
    print(f"served {server.served} requests / {server.tokens_out} tokens "
          f"in {server.steps} decode steps ({dt:.2f}s, "
          f"{summary['tokens_per_s']:.0f} tok/s, policy={args.policy}, "
          f"device={device}); prompt-echo check: "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok or server.served != args.requests:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()

"""Off-policy replay on the card: the mixed batches ``ReplaySource`` makes
from CUDA tensors equal, bitwise, those it makes from the same CPU
tensors; its host copy waits for the fresh batch and not for the device
work queued after it (a double-buffered source's next unroll); and the
entry point trains with ``--replay`` through the V-trace kernel. This file
imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_replay_gpu.py

Without a GPU every case skips."""

import time

import numpy as np
import pytest
import torch

from repro_torch.core import replay as treplay
from repro_torch.core.sources import ReplaySource
from repro_torch.kernels import ops
from repro_torch.launch import train

T, B, A = 6, 4, 3
OBS = (5, 5, 2)
KINDS = ["uniform", "elite", "attentive"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _rollouts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "obs": rng.random((T + 1, B) + OBS, dtype=np.float32),
        "action": rng.integers(0, A, (T, B)).astype(np.int32),
        "behavior_logits": rng.normal(0, 1, (T, B, A)).astype(np.float32),
        "reward": rng.normal(0, 1, (T, B)).astype(np.float32),
        "done": rng.random((T, B)) < 0.1,
    } for _ in range(n)]


class _Source:
    """Hands out the given rollouts on ``device``; with ``busy_cycles``
    it records ``ready_event`` after each batch and then queues that many
    cycles of device sleep, as a double-buffered source queues its next
    unroll."""

    frames_per_batch = T * B

    def __init__(self, rollouts, device, busy_cycles=0):
        self._rollouts = [{k: torch.from_numpy(v).to(device)
                           for k, v in r.items()} for r in rollouts]
        self._busy = busy_cycles
        self.ready_event = None

    def start(self, params):
        pass

    def next_batch(self, params):
        batch = self._rollouts.pop(0)
        if self._busy:
            self.ready_event = torch.cuda.current_stream().record_event()
            torch.cuda._sleep(self._busy)
        return batch

    def stop(self):
        pass


def _values(params, obs):
    del params
    return obs[:, :, 0, 0, 0] * 2.0 - 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_mixed_batches_on_the_card_equal_the_cpu_ones(cuda_device, kind):
    rollouts = _rollouts(5)
    prios = np.random.default_rng(1).random((5, 2 * B)).astype(np.float32)
    sources = {d: ReplaySource(_Source(rollouts, d),
                               treplay.make_buffer(kind, 12), seed=3,
                               value_fn=_values)
               for d in ("cpu", cuda_device)}
    for i in range(5):
        got = sources[cuda_device].next_batch(None)
        want = sources["cpu"].next_batch(None)
        assert set(got) == set(want)
        for k in want:
            assert got[k].device.type == "cuda", k
            assert torch.equal(got[k].cpu(), want[k]), k
        for d, rs in sources.items():
            rs.on_learner_metrics(i, {"priority": torch.from_numpy(
                prios[i]).to(d)})
        assert sources[cuda_device]._last_ids == sources["cpu"]._last_ids
        assert sources[cuda_device].stats() == sources["cpu"].stats()


@pytest.mark.gpu
def test_host_copy_does_not_wait_for_the_work_queued_after_the_batch(
        cuda_device):
    """The inner source queues about half a second of device work after
    its batch's ``ready_event``; ``next_batch`` must come back while that
    work still runs, with the right batch."""
    rollouts = _rollouts(3)
    cycles = 10 ** 9                  # about 0.5 s at the H100's 1.98 GHz
    rs = ReplaySource(_Source(rollouts, cuda_device, busy_cycles=cycles),
                      treplay.make_buffer("elite", 12), seed=0,
                      value_fn=_values)
    ref = ReplaySource(_Source(rollouts, "cpu"),
                       treplay.make_buffer("elite", 12), seed=0,
                       value_fn=_values)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = rs.next_batch(None)
        host_s = time.perf_counter() - t0
        still_busy = not torch.cuda.current_stream().query()
        want = ref.next_batch(None)
        assert still_busy, "the queued device work ended before next_batch"
        assert host_s < 0.25, f"next_batch took {host_s:.3f}s on the host"
        for k in want:
            assert torch.equal(batch[k].cpu(), want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_main_replay_on_the_card(cuda_device, kind):
    before = ops.stats()["vtrace"]
    runtime = train.main(["--steps", "3", "--batch", "8", "--replay", kind,
                          "--replay-capacity", "16"])
    assert ops.stats()["vtrace"] - before == 3
    assert ops.last_vtrace_chunks() != (0, 0)
    assert runtime.metrics["priority"].shape == (16,)
    for key in ("loss", "clear_policy_loss", "clear_value_loss"):
        assert np.isfinite(float(runtime.metrics[key])), key

"""Model parallel on the card: the reduced ``qwen3-4b`` and
``zamba2-2.7b`` at mesh (1, 2), both ranks sharing cuda:0 through gloo,
through the kernel paths (flash attention and the SSD chunk on each
rank's heads), against the same run on the CPU (the kernels' plain
versions there): a ``--mode lm`` step on each of three batches from the
seed-0 weights, float32, losses within 1e-5; and the ranks launch the
kernels. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_mesh2d_gpu.py

Without a GPU every case skips."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core import learner
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import optimizers

pytestmark = pytest.mark.gpu

RULES = sharding.MEGATRON_RULES


def _rank(mesh, arch):
    import repro_torch
    if mesh.device.type == "cuda":
        repro_torch.resolve_device("cuda")
    cfg = dataclasses.replace(get_reduced_config(arch), attn_impl="kernel",
                              ssd_impl="kernel")
    opt = optimizers.adamw(1e-3)
    step = learner.make_lm_pretrain_step(cfg, opt, loss_chunk=32, mesh=mesh,
                                         rules=RULES)
    rng = np.random.default_rng(0)
    ops.reset_stats()
    losses = []
    for _ in range(3):
        # drawn on the CPU in both runs: a CUDA generator draws others
        params = model_lib.shard_model(model_lib.init(cfg, seed=0), cfg,
                                       mesh, RULES).to(mesh.device)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)))
        _, _, m = step(params, opt.init(list(params.parameters())), 0,
                       {"tokens": tokens.to(mesh.device)})
        losses.append(float(m["loss"]))
    return sharding.gather_to_main((losses, ops.stats()), mesh)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-2.7b"])
def test_model_2_on_the_card_matches_the_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    cpu = mesh_lib.launch(_rank, 2, device="cpu", model=2, args=(arch,),
                          timeout_s=300)
    card = mesh_lib.launch(_rank, 2, device="cuda", model=2, args=(arch,),
                           devices=["cuda:0", "cuda:0"], backend="gloo",
                           timeout_s=300)
    for (got, launches), (want, _) in zip(card, cpu):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert launches["flash_attention"] > 0
        if arch == "zamba2-2.7b":
            assert launches["ssd_chunk"] > 0

"""PyTorch port of the IMPALA/V-trace platform in ``repro`` for one
NVIDIA H100.

The package mirrors ``repro``'s layout module for module (configs, data,
envs, models, kernels, core, optim, launch) and imports nothing of it, nor
JAX.
Its hot kernels are hand-written CUDA C++ for ``sm_90a`` under
``kernels/csrc/``: V-trace for the trainer, flash attention and decode
attention for the decoder and the server, and the Mamba2 SSD chunk for the
Zamba2 hybrid; every other op is plain PyTorch.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); see :func:`resolve_device`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names
    another. Asking for CUDA on a host without a GPU raises; nothing falls
    back to the CPU.

    This is also the one place that pins float32 precision on the card:
    cuDNN convolutions default to TF32 on Hopper (about three decimal
    digits), and the port is held to the JAX reference in full float32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

"""Public wrappers for the hand-written kernels.

Each wrapper dispatches on where its tensors lie. On the CPU it runs the
kernel's plain version (``ref.py``). On CUDA it checks what the kernel
takes, launches it on the current stream, and raises on anything else:
there is no fallback from a CUDA tensor to the plain version, and a kernel
that fails to build is an error. Each launch adds one to the kernel's
count in ``stats()``, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

_launches: Dict[str, int] = {"vtrace": 0}


def stats() -> Dict[str, int]:
    """Kernel launches since the last ``reset_stats()``, by kernel."""
    return dict(_launches)


def reset_stats() -> None:
    for name in _launches:
        _launches[name] = 0


def _vtrace_fn():
    lib = _build.load("vtrace")
    fn = lib.vtrace_from_importance_weights
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _threshold(x):
    return math.inf if x is None else float(x)


def vtrace_from_importance_weights_kernel(
        log_rhos, discounts, rewards, values, bootstrap_value, *,
        clip_rho_threshold=1.0, clip_c_threshold=1.0,
        clip_pg_rho_threshold=1.0):
    """V-trace with the whole computation in one launch of the CUDA kernel
    ``csrc/vtrace.cu`` (drop-in for ``core.vtrace.
    vtrace_from_importance_weights``). log_rhos, discounts, rewards, values:
    (T, B) float32; bootstrap_value: (B,). ``None`` thresholds mean no
    clipping. Returns VTraceReturns(vs, pg_advantages), with no gradient."""
    from repro_torch.core.vtrace import VTraceReturns

    args = (log_rhos, discounts, rewards, values, bootstrap_value)
    if all(x.device.type == "cpu" for x in args):
        return VTraceReturns(*_ref.ref_vtrace_from_importance_weights(
            *args, clip_rho_threshold=clip_rho_threshold,
            clip_c_threshold=clip_c_threshold,
            clip_pg_rho_threshold=clip_pg_rho_threshold))

    device = values.device
    if device.type != "cuda" or any(x.device != device for x in args):
        raise ValueError("vtrace kernel: all inputs must lie on one CUDA "
                         f"device, got {[str(x.device) for x in args]}")
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("vtrace kernel takes float32, got "
                        f"{[x.dtype for x in args]}")
    if values.dim() != 2:
        raise ValueError(f"vtrace kernel: values must be (T, B), "
                         f"got {tuple(values.shape)}")
    t, b = values.shape
    if any(x.shape != (t, b) for x in args[:4]) \
            or bootstrap_value.shape != (b,):
        raise ValueError("vtrace kernel: shapes must be (T, B) x4 and (B,), "
                         f"got {[tuple(x.shape) for x in args]}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("vtrace kernel: inputs must be contiguous")

    vs = torch.empty_like(values)
    pg_advantages = torch.empty_like(values)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _vtrace_fn()(
            *(x.data_ptr() for x in args), vs.data_ptr(),
            pg_advantages.data_ptr(), t, b,
            _threshold(clip_rho_threshold), _threshold(clip_c_threshold),
            _threshold(clip_pg_rho_threshold), stream)
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: CUDA error {err}")
    _launches["vtrace"] += 1
    return VTraceReturns(vs, pg_advantages)

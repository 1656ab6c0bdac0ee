"""Static CUDA launch-geometry audit: the card's contracts the CPU tests
skip, after the reference's ``analysis/kernel_audit.py``.

The CPU tests run every kernel's plain version, which checks the math but
not the launches: a grid past the card's limits, a block of too many
threads or too much dynamic shared memory, or a shape a ``.cu`` was not
compiled for shows only on the card, as a refused launch. This module
checks them with arithmetic alone. For every arch of ``configs/`` and
every input shape of ``INPUT_SHAPES`` whose program reaches a kernel (and
the rl-agent trainers' V-trace shapes), it takes the launches the
wrapper would make from ``kernels/ops.py::launch_geometry`` (the Python
mirror that ``chip_smoke.py`` holds equal to each ``.cu``'s own
``<kernel>_geometry`` export on the card) and holds them to an H100's
limits:

  * grid x at most 2^31 - 1, y and z at most 65,535, every one >= 1
    (``kernel-grid``);
  * at most 1,024 threads a block (``kernel-threads``);
  * dynamic shared memory a block at most 232,448 bytes
    (``kernel-smem``);
  * what the ``.cu`` was compiled for: the attention kernels' head dims
    (64, 80, 128, 256), the SSD chunk's head dims (16, 32, 64) and a
    state size that is a multiple of 4 (``kernel-head-dim``), and a
    Mamba2 length that is at most one chunk or a multiple of it, as the
    model requires (``kernel-ssd-length``).

Each audited launch is joined with ``launch/roofline.py``'s
``kernel_roofline`` for the same call, so the report reads geometry and
FLOPs side by side per (kernel, arch, shape).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.common import Finding
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import ops
from repro_torch.launch.roofline import kernel_roofline

AUDIT_KERNELS = ("flash_attention", "decode_attention", "ssd_chunk",
                 "vtrace")
# the rl-agent trainers' (T, B) of V-trace: the trainer, the paper's
# learner at full width, and replay's mixed batch
RL_AGENT_VTRACE = ((20, 32), (80, 32), (80, 64))


@dataclasses.dataclass
class Launch:
    """One kernel launch, fully static."""
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem_bytes: int
    file: str = ""
    line: int = 0


def _src(fn) -> Tuple[str, int]:
    raw = inspect.unwrap(fn)
    return inspect.getsourcefile(raw) or "", raw.__code__.co_firstlineno


_WRAPPERS = {"flash_attention": ops.flash_attention,
             "decode_attention": ops.decode_attention,
             "ssd_chunk": ops.ssd_chunk,
             "vtrace": ops.vtrace_from_importance_weights_kernel}


def audit_launch(launch: Launch) -> Tuple[List[Finding], Dict]:
    """The card's limits on one launch: findings and its table row."""
    findings = []

    def flag(rule, message):
        findings.append(Finding(rule=rule, file=launch.file,
                                line=launch.line,
                                message=f"{launch.kernel}: {message}"))

    limits = (ops.GRID_X_MAX, ops.GRID_YZ_MAX, ops.GRID_YZ_MAX)
    for axis, size, most in zip("xyz", launch.grid, limits):
        if not 1 <= size <= most:
            flag("kernel-grid", f"grid {axis} = {size} outside [1, {most}]")
    if not 1 <= launch.threads <= ops.BLOCK_THREADS_MAX:
        flag("kernel-threads", f"{launch.threads} threads a block, the "
                               f"card takes 1..{ops.BLOCK_THREADS_MAX}")
    if launch.smem_bytes > ops.MAX_SMEM_BYTES:
        flag("kernel-smem", f"{launch.smem_bytes} bytes of dynamic shared "
                            f"memory a block, more than the card's "
                            f"{ops.MAX_SMEM_BYTES}")
    table = {"kernel": launch.kernel, "grid": list(launch.grid),
             "threads": launch.threads, "smem_bytes": launch.smem_bytes,
             "ok": not findings}
    return findings, table


def _attn_kinds(cfg):
    kinds = [m for m, _ in cfg.block_pattern
             if m in ("attn", "local_attn", "swa_attn")]
    if cfg.shared_attn_every:
        kinds.append("attn")
    return kinds


def _window(cfg):
    kinds = _attn_kinds(cfg)
    return cfg.sliding_window if kinds and all(
        m in ("swa_attn", "local_attn") for m in kinds) else 0


def _cases(arch, cfg, shape):
    """(kernel, dims for launch_geometry, dims for kernel_roofline,
    findings of what the .cu was compiled for) of every kernel the
    (arch, shape) program reaches."""
    b, s, kind = shape.global_batch, shape.seq_len, shape.kind
    bf16 = cfg.dtype == "bfloat16"
    esize = 2 if bf16 else 4
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bad_hd = None if hd in ops.ATTN_HEAD_DIMS else \
        f"head_dim {hd} is not one of {ops.ATTN_HEAD_DIMS}"
    if _attn_kinds(cfg):
        if kind == "decode":
            window = _window(cfg)
            slots = min(s, window) if window else s
            yield ("decode_attention",
                   dict(b=b, h=h, kh=kh, s=slots, hd=hd, bf16=bf16),
                   dict(dtype_bytes=esize, b=b, h=h, kh=kh, s=slots, hd=hd),
                   bad_hd)
        else:
            yield ("flash_attention", dict(b=b, h=h, sq=s, hd=hd, bf16=bf16),
                   dict(dtype_bytes=esize, b=b, h=h, kh=kh, s=s, hd=hd,
                        window=_window(cfg)), bad_hd)
    if any(m == "mamba" for m, _ in cfg.block_pattern) and kind != "decode":
        chunk = min(cfg.ssm_chunk, 128) if kind == "train" else cfg.ssm_chunk
        length = min(chunk, s)
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        n, p = cfg.ssm_state, cfg.ssm_head_dim
        bad = None
        if p not in ops.SSD_HEAD_DIMS or n % 4:
            bad = (f"ssd head dim {p} not in {ops.SSD_HEAD_DIMS} or state "
                   f"size {n} not a multiple of 4")
        yield ("ssd_chunk", dict(rows=b * nh, l=length, n=n, p=p),
               dict(dtype_bytes=4, bh=b * nh, l=length, n=n, p=p), bad)
        if s > chunk and s % chunk:
            yield ("ssd_length", None, None,
                   f"sequence {s} is over one chunk of {chunk} and not a "
                   "multiple of it")
    if kind == "train":
        yield ("vtrace", dict(t=s, b=b), dict(t=s, b=b), None)


def audit_kernels(archs: Optional[Sequence[str]] = None
                  ) -> Tuple[List[Finding], List[Dict]]:
    """Audit every kernel launch of every arch x input shape (and the
    rl-agent trainers' V-trace). Returns (findings, table rows)."""
    from repro_torch.launch.specs import resolve_config
    findings: List[Finding] = []
    tables: List[Dict] = []

    def audit(kernel, arch, label, dims, roof, bad):
        file, line = _src(_WRAPPERS["ssd_chunk" if kernel == "ssd_length"
                                    else kernel])
        if bad is not None:
            rule = "kernel-ssd-length" if kernel == "ssd_length" \
                else "kernel-head-dim"
            findings.append(Finding(rule=rule, file=file, line=line,
                                    message=f"{kernel}[{arch}/{label}]: "
                                            f"{bad}"))
        if dims is None:
            return
        for launch in ops.launch_geometry(kernel, **dims):
            grid, threads, smem = launch
            fnd, row = audit_launch(Launch(kernel, tuple(grid), threads,
                                           smem, file, line))
            for f in fnd:
                f.message = f"[{arch}/{label}] {f.message}"
            findings.extend(fnd)
            row.update(arch=arch, shape=label, dims=dims,
                       roofline=kernel_roofline(kernel, **roof))
            tables.append(row)

    for arch in archs or ARCHS:
        for name, shape in INPUT_SHAPES.items():
            cfg = resolve_config(arch, shape, get_config(arch))
            for kernel, dims, roof, bad in _cases(arch, cfg, shape):
                audit(kernel, arch, name, dims, roof, bad)
    for t, b in RL_AGENT_VTRACE:
        audit("vtrace", "rl-agent", f"t{t}_b{b}", dict(t=t, b=b),
              dict(t=t, b=b), None)
    return findings, tables

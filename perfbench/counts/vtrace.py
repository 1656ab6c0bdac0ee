"""The work of one launch of the V-trace kernel (K1,
``csrc/vtrace.cu``) at (T, B), as its inputs need it.

This count differs from ``repro_torch.launch.roofline.kernel_roofline``
("vtrace"), which follows the JAX reference's formula for its
``vtrace_scan`` alone: the deltas and the discounts times c read, the
accumulator written, 3 arrays and 3 operations a cell. The port's kernel
computes the whole function from the learner's tensors, so the work these
inputs need is more: it reads log_rhos, discounts, rewards and values
(T, B) and the bootstrap value (B,), and writes vs and the policy-gradient
advantages (T, B), 6 float32 arrays a cell and B more; and it computes,
a cell, the exponent, the three clips, the delta (4), the recursion (2),
vs (1) and the advantage (4): 15 operations. The kernel is bound by its
bytes either way.
"""

from __future__ import annotations

OPS_A_CELL = 15


def launch(t: int, b: int):
    """(FLOPs, bytes) of one launch."""
    return float(OPS_A_CELL * t * b), float(4 * (6 * t * b + b))

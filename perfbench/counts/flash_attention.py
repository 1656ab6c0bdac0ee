"""The work of one launch of the flash-attention kernel (K2,
``csrc/flash_attention.cu``): ``sq`` queries at ``q_offset`` against
``sk`` keys, causal, no window.

FLOPs: 4 a visited (query, key) pair and head dimension (q k^T and P V,
2 a multiply-add), the pairs being those the causal mask keeps. Bytes: q
and the output once (``h`` heads), k and v once (``kh`` heads), in the
activations' type. For these shapes (no window, queries at offset 0 and
``sq == sk``) this is ``repro_torch.launch.roofline.kernel_roofline``'s
count; under a window that count caps every query's span, where this one
would count the pairs the inputs need.
"""

from __future__ import annotations


def pairs(sq: int, sk: int, q_offset: int = 0) -> int:
    return sum(min(q_offset + i + 1, sk) for i in range(sq))


def launch(b, h, kh, sq, sk, hd, dtype_bytes, q_offset=0):
    """(FLOPs, bytes) of one launch."""
    flops = 4.0 * b * h * pairs(sq, sk, q_offset) * hd
    nbytes = dtype_bytes * (2.0 * b * h * sq * hd + 2.0 * b * kh * sk * hd)
    return flops, nbytes

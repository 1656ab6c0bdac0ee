"""The work of one call of the decode-attention kernel (K3,
``csrc/decode_attention.cu``, its split launch and the launch that
merges the splits): one query token a row against ``valid`` cache slots.

FLOPs: 4 a valid slot, query head and head dimension. Bytes: k and v of
the valid slots once (``kh`` heads), the query and the output once (``h``
heads), in the cache's type, and the int32 slot positions and position.

``repro_torch.launch.roofline.kernel_roofline`` ("decode_attention")
counts every slot of the cache, ``s``; the kernel reads and weighs only
the slots at or before each row's position, so this count takes the
valid slots alone: the work these inputs need.
"""

from __future__ import annotations


def launch(b, h, kh, valid, hd, dtype_bytes, slots=None):
    """(FLOPs, bytes) of one call; ``slots``: the cache's slots (their
    positions are read), default ``valid``."""
    flops = 4.0 * b * h * valid * hd
    nbytes = dtype_bytes * (2.0 * b * kh * valid * hd + 2.0 * b * h * hd) \
        + 4.0 * ((slots or valid) + 1)
    return flops, nbytes

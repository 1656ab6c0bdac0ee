"""Host-side batching helpers. Only the bucket ladder is ported so far; the
``DynamicBatcher`` and ``BatchingQueue`` of the reference come with the
host actors (ROADMAP item 12)."""

from __future__ import annotations


def bucket_size(n: int, ladder=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    """The smallest ladder size that holds ``n``, or ``n`` itself past the
    ladder's top: padding to a few sizes bounds the distinct shapes a
    compiled or captured step has to serve."""
    for b in ladder:
        if n <= b:
            return b
    return n

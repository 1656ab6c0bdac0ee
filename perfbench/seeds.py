"""Seeds derived from a run's ``--seed``: one stream for each thing the
run draws (the weights, the traffic, the frames), so that changing what
one of them draws leaves the others as they were. Any whole number is a
seed; each derived seed fits a ``torch.Generator`` and numpy."""

from __future__ import annotations

import hashlib


def derive(seed: int, name: str) -> int:
    """A 63-bit seed for ``name`` from ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1

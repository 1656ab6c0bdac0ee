"""Data-parallel collectives over ``torch.distributed`` (``sharding``)."""
from repro_torch.distributed import sharding  # noqa: F401

"""Hand-written Hopper kernels (``csrc/``), their build (``build.py``),
plain PyTorch versions (``ref.py``) and wrappers (``ops.py``)."""

"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on
NVIDIA GPUs: ``python3 perfbench/run.py --workload <cell> ...`` (see
``README.md``). Nothing here imports JAX or the JAX package ``repro``."""

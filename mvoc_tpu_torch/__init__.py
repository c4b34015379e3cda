"""mvoc_tpu_torch: multi-video object composition in PyTorch for one NVIDIA
H100 — the port of the JAX package `mvoc_tpu`, which stays its reference.

The port imports torch, numpy and PIL only.  Its hand-written CUDA kernels
live in `csrc/` and are built with nvcc at first use (`ops/_build.py`).
"""

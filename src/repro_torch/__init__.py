"""PULSE in PyTorch and CUDA: the port of ``repro`` to NVIDIA H100 GPUs.

The JAX package ``repro`` is the reference; this package keeps its module
names, so each module here has a counterpart there, and it imports nothing
of it (nor of JAX).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper uses its plain PyTorch
version, on a CUDA tensor it launches its hand-written kernel or raises.
"""

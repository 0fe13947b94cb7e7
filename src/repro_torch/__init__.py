"""PyTorch / CUDA port of the MPSL framework, for one NVIDIA H100.

Mirrors the layout of the JAX package (``configs/``, ``models/``,
``kernels/``, ``launch/``) and keeps its tensor layouts at every public
function, so the two can be compared like with like. Every Pallas kernel
of the JAX package becomes a kernel written by hand for Hopper under
``kernels/``; plain tensor code is PyTorch.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; on the
CPU each kernel's plain PyTorch version runs instead.
"""

"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  flash_attention — forward (``csrc/flash_attention_fwd.cu``) and backward
                    (``csrc/flash_attention_bwd.cu``: dq, then dk/dv), CUDA
                    C++. Online-softmax GQA attention masked by absolute
                    positions, emitting o and the row LSE; the backward
                    rebuilds p from the LSE. bf16 runs on the tensor cores,
                    f32 on the CUDA cores, decode by split-KV. Serves
                    prefill, decode and the train step.
  softmax_xent    — the LM-head cross-entropy, forward (vocab split across
                    blocks, partials merged) and backward (dh, dw through a
                    [T, 8192] ds slab), CUDA C++ (``csrc/softmax_xent.cu``):
                    one wgmma GEMM on the tensor cores, every product from
                    bf16 pieces of the f32 operands.
  quant8          — per-row int8 quant-dequant of the MPSL links: round to
                    nearest, or stochastic with uniforms streamed in or
                    drawn by an in-kernel Philox, CUDA C++
                    (``csrc/quant8.cu``).

``build.py`` compiles ``csrc/*.cu`` with nvcc into shared libraries with
a plain C interface, loaded with ctypes; ``ops.py`` routes a CUDA tensor
to the kernel and a CPU tensor to the plain version, with each kernel's
gradient as a ``torch.autograd.Function``; ``ref.py`` holds the oracles.
"""

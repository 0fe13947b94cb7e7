"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  flash_attention — forward (CUDA C++, ``csrc/flash_attention_fwd.cu``).
                    Online-softmax GQA attention masked by absolute
                    positions, emitting o and the row LSE. Serves prefill
                    and decode; its backward comes with the training slice.

``build.py`` compiles ``csrc/*.cu`` with nvcc into shared libraries with
a plain C interface, loaded with ctypes; ``ops.py`` routes a CUDA tensor
to the kernel and a CPU tensor to the plain version; ``ref.py`` holds the
oracles.
"""

"""haploconduct_torch — the assembler on PyTorch and CUDA (NVIDIA Hopper).

A second package beside haploconduct_tpu, which stays the reference. A
module of the reference that never touches jax is imported from it as it
is; a module that reaches jax (or imports by name a function that can)
has a twin here at the same relative path. The one device hot loop,
overlap scoring, runs as a hand-written CUDA kernel
(csrc/score_segments.cu) on a CUDA device and as its plain PyTorch
version on the CPU. This package never imports jax.
"""

__version__ = "0.1.0"

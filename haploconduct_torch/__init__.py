"""haploconduct_torch — the assembler on PyTorch and CUDA (NVIDIA Hopper).

A package of its own beside haploconduct_tpu, which stays the reference
the port is tested against. It imports nothing of that package and no jax:
the host pipeline (read store, formats, graph, cliques, superreads, FNO,
the k-mer engine, the aligner, the g++ extensions) is its own copy, and
the modules that reached jax are rewritten on torch. Overlap scoring runs
as a hand-written CUDA kernel (csrc/score_tasks.cu) on a CUDA device and
as its plain PyTorch version on the CPU; POLYTE's exact re-overlap passes
run the k-mer sort-join in torch ops (ops/kmer_device.py) on the same
device.
"""

__version__ = "0.1.0"

# Large-buffer allocator tuning (see utils/hostmem.py): the host phases
# churn multi-MB NumPy temporaries every iteration; on lazily-faulted VM
# memory the default glibc mmap-per-allocation costs ~50x. Opt out with
# HC_NO_MALLOC_TUNE=1.
from .utils.hostmem import tune_allocator as _tune_allocator

_tune_allocator()

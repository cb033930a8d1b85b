"""Multi-process work sharding — twin of haploconduct_tpu/parallel/distributed.py.

Single process first: torch.distributed is used only when a process group
is already initialized, or when the standard RANK / WORLD_SIZE variables
(with MASTER_ADDR / MASTER_PORT, as torchrun sets them) ask for one. Work
items are round-robined over ranks and the per-item results are gathered
back to every rank with all_gather_object, so the joint stages run
replicated. The store/subread encoding is the reference's.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from haploconduct_tpu.parallel.distributed import (  # noqa: F401
    decode_store_subreads, encode_store_subreads)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def maybe_initialize() -> bool:
    """Join the process group the environment describes; True when more
    than one process takes part. Safe to call more than once."""
    dist = _dist()
    if dist is None:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
        return False
    import torch

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, init_method="env://")
    return dist.get_world_size() > 1


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None and dist.is_initialized() else 0


def my_work_items(n_items: int) -> List[int]:
    """Round-robin assignment of patch indices to this process."""
    pc, pi = process_count(), process_index()
    return [i for i in range(n_items) if i % pc == pi]


def allgather_stage_results(results: Sequence, indices: Sequence[int],
                            n_total: int) -> list:
    """Merge per-process stage results back into dense index order on
    every process."""
    if process_count() == 1:
        return list(results)
    from haploconduct_tpu.assemble.stages import StageResult

    mine = {int(i): dict(encode_store_subreads(r.store, r.subreads),
                         iterations=r.iterations)
            for i, r in zip(indices, results)}
    gathered: list = [None] * process_count()
    _dist().all_gather_object(gathered, mine)
    merged = {}
    for part in gathered:
        for idx, blob in part.items():
            store, sub = decode_store_subreads(blob)
            merged[idx] = StageResult(store=store, subreads=sub, overlap_lines=[],
                                      iterations=int(blob["iterations"]))
    missing = [i for i in range(n_total) if i not in merged]
    if missing:
        raise RuntimeError(f"work items {missing} produced by no process")
    return [merged[i] for i in range(n_total)]

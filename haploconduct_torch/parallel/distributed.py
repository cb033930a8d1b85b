"""Multi-process work sharding over torch.distributed.

Single process first: torch.distributed is used only when a process group
is already initialized, or when the standard RANK / WORLD_SIZE variables
(with MASTER_ADDR / MASTER_PORT, as torchrun sets them) ask for one. With
CUDA each rank first takes its own card (LOCAL_RANK, else RANK modulo the
card count), so scoring and NCCL's object collectives use that card. Work
items are round-robined over ranks and the per-item results are gathered
back to every rank with all_gather_object, so the joint stages run
replicated, their verify calls over the mesh that spans the ranks
(parallel/mesh.py; the work items themselves run inside
mesh.rank_local()). A (ReadStore, SubreadDict) pair travels as JSON, its
subreads in the reference's subreads.txt text format. SAVAGE's abundance
filters deal the sample's reads to the ranks and gather each rank's
equivalence classes (allgather_classes) as flat int32 arrays.

The group's collectives wait for the slowest rank: the gather after
SAVAGE stage a waits while that rank assembles its last patch, so the
group's timeout (COLLECTIVE_TIMEOUT) is set far above a stage's time
rather than left at NCCL's ten-minute default.

GATHER_STATS counts this process's object gathers (under a lock): the
calls of all_gather_object, the bytes of the blobs it received (every
rank's, its own among them), the seconds inside all_gather_object (the
wait for the slowest rank and the exchange) and the seconds of the JSON
encode and decode around them. A single process gathers nothing and
counts nothing.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import time
from typing import List, Sequence

import numpy as np

from ..core.reads import ReadStore
from ..io.subreads import subreads_from_text, subreads_to_text


COLLECTIVE_TIMEOUT = datetime.timedelta(hours=4)

GATHER_STATS = {"calls": 0, "bytes": 0, "wait_s": 0.0, "codec_s": 0.0}
_stats_lock = threading.Lock()


def _count(**add) -> None:
    with _stats_lock:
        for key, value in add.items():
            GATHER_STATS[key] += value


def gather_stats() -> dict:
    """A copy of GATHER_STATS, read under its lock."""
    with _stats_lock:
        return dict(GATHER_STATS)


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

    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        card = (int(local) if local is not None
                else int(os.environ["RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(card)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=COLLECTIVE_TIMEOUT)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group, when this process joined one."""
    dist = _dist()
    if dist is not None and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None and dist.is_initialized() else 0


def my_work_items(n_items: int) -> List[int]:
    """Round-robin assignment of patch/region indices to this process."""
    pc, pi = process_count(), process_index()
    return [i for i in range(n_items) if i % pc == pi]


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Collect one byte blob from every process, in process order
    (all_gather_object over the process group; identity alone)."""
    if process_count() == 1:
        return [payload]
    gathered: list = [None] * process_count()
    t0 = time.perf_counter()
    _dist().all_gather_object(gathered, bytes(payload))
    _count(calls=1, bytes=sum(len(b) for b in gathered),
           wait_s=time.perf_counter() - t0)
    return gathered


def allgather_classes(class_counts: dict, class_members: dict,
                      n_aligned: int) -> list:
    """Every process's classify_all result (ops/abundance.py), in process
    order, each as (class_counts, class_members, n_aligned) with its classes
    in their order. One flat int32 blob a process: the class count and
    n_aligned, the counts, the members' offsets, the members."""
    keys = list(class_counts)
    members = [class_members[key] for key in keys]
    head = np.array([len(keys), n_aligned] + [class_counts[key] for key in keys]
                    + [0] + [len(m) for m in members], np.int64)
    head[2 + len(keys):] = np.cumsum(head[2 + len(keys):])
    blob = np.concatenate([head] + members).astype(np.int32).tobytes()
    out = []
    for data in allgather_bytes(blob):
        flat = np.frombuffer(data, np.int32)
        n = int(flat[0])
        counts = flat[2:2 + n]
        offsets = flat[2 + n:3 + 2 * n]
        pool = flat[3 + 2 * n:]
        got_counts, got_members = {}, {}
        for j in range(n):
            mem = pool[offsets[j]:offsets[j + 1]]
            key = mem.tobytes()
            got_counts[key] = int(counts[j])
            got_members[key] = mem
        out.append((got_counts, got_members, int(flat[1])))
    return out


def encode_store_subreads(store, subreads) -> dict:
    """JSON-serializable form of a (ReadStore, SubreadDict) pair; the
    subreads travel in the reference's subreads.txt text format."""
    if store is None:
        return None
    singles = []
    paired = []
    for i in range(len(store)):
        rid = store.ids[i]
        if store.is_paired[i]:
            paired.append((rid, store.seq_str(i, 1), store.phred_str(i, 1),
                           store.seq_str(i, 2), store.phred_str(i, 2)))
        else:
            singles.append((rid, store.seq_str(i), store.phred_str(i)))
    return {
        "singles": singles,
        "paired": paired,
        "subreads": subreads_to_text(subreads) if subreads else "",
    }


def decode_store_subreads(blob):
    if blob is None:
        return None, None
    store = ReadStore()
    for rid, seq, phred in blob["singles"]:
        store.add_single(int(rid), seq, phred)
    store.readcount_single = len(blob["singles"])
    for rid, s1, p1, s2, p2 in blob["paired"]:
        store.add_paired(int(rid), s1, p1, s2, p2)
    sub = subreads_from_text(blob["subreads"]) if blob["subreads"] else None
    return store, sub


def allgather_indexed(items: Sequence, indices: Sequence[int], n_total: int,
                      encode, decode, allow_missing: bool = False) -> list:
    """Merge per-process work results back into dense index order on every
    process: each process encodes its items to JSON blobs, the blobs are
    allgathered, and every index is decoded locally. With allow_missing an
    index no process produced comes back as None."""
    if process_count() == 1:
        return list(items)
    t0 = time.perf_counter()
    my_blob = json.dumps({str(idx): encode(res)
                          for idx, res in zip(indices, items)}).encode()
    codec_s = time.perf_counter() - t0
    gathered = allgather_bytes(my_blob)
    t0 = time.perf_counter()
    merged: dict = {}
    for data in gathered:
        for key, blob in json.loads(data.decode()).items():
            merged[int(key)] = decode(blob) if blob is not None else None
    _count(codec_s=codec_s + time.perf_counter() - t0)
    missing = [i for i in range(n_total) if i not in merged]
    if missing and not allow_missing:
        raise RuntimeError(f"work items {missing} produced by no process")
    return [merged.get(i) for i in range(n_total)]


def allgather_stage_results(results: Sequence, indices: Sequence[int],
                            n_total: int) -> list:
    """allgather_indexed specialization for assemble.stages.StageResult."""
    from ..assemble.stages import StageResult

    def encode(res) -> dict:
        blob = encode_store_subreads(res.store, res.subreads)
        blob["iterations"] = res.iterations
        return blob

    def decode(blob: dict):
        store, sub = decode_store_subreads(blob)
        return StageResult(store=store, subreads=sub, overlap_lines=[],
                           iterations=int(blob["iterations"]))

    return allgather_indexed(results, indices, n_total, encode, decode)

"""Ranks 1..P-1 of a cell that spans P cards, run by the cell's own
process, which is rank 0 on card 0.

Rank 0 starts each other rank as a child process (`python3 -m
benchlib.ranks`) on its own card, and all of them join one process group
that rank 0 creates (NCCL on the cards, gloo on the CPU, at
tcp://127.0.0.1:<free port>, with a timeout of GROUP_TIMEOUT_S); the
program's parallel/distributed.maybe_initialize() then finds the group
initialized and keeps it. A child gets its spec (its rank, the seed, the
draws, the driver and the program's options) as the first line on its
standard input, draws the same units from the seed as rank 0, and then
takes one command a line: `{"op": "warmup"}`, `{"op": "unit", "k": k}` (the
index of a unit of the pool: only the index travels) or `{"op": "stop"}`.
For each unit it runs the driver's `run_sample(store, options)` and
answers one line on its standard output: its timings, the SHA-256 of its
final contigs (contig_digest) and its peak device memory.

Nothing may hang. A child that dies, errs or stays silent for
GROUP_TIMEOUT_S makes rank 0 print why, kill the children and exit with
1 at once (`fatal`), even while rank 0 waits in a collective; a child
whose standard input closes before a stop exits with 3, as rank 0 is
gone. `stop()` ends the children and leaves the group.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import traceback

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
GROUP_TIMEOUT_S = 300


def rank_threads(world: int) -> int:
    """Host threads a rank: this host's cores shared by the ranks, as
    torchrun shares them between the processes of a node."""
    return max(1, len(os.sched_getaffinity(0)) // world)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def contig_digest(store, subreads) -> str:
    """SHA-256 of a set of single-end contigs in order: each contig's id,
    bases, phreds and its original reads (id, offset, strand) sorted by
    id. None (no contigs) has the digest of an empty set."""
    h = hashlib.sha256()
    for i in range(len(store) if store is not None else 0):
        rid = int(store.ids[i])
        u = store.unit1[i]
        h.update(np.int64(rid).tobytes())
        for arr in (store.unit_codes(u), store.unit_quals(u)):
            a = np.ascontiguousarray(arr)
            h.update(np.int64(a.size).tobytes() + a.tobytes())
        placed = sorted((int(oid), int(oi.index1), bool(oi.forward))
                        for oid, oi in (subreads or {}).get(rid, {}).items())
        h.update(json.dumps(placed).encode())
    return h.hexdigest()


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def child_command(rank: int) -> list:
    """The command that runs rank `rank` (> 0)."""
    return [sys.executable, "-m", "benchlib.ranks"]


def fatal(message: str, procs=()) -> None:
    """Print `message` and the exception being handled, if any, kill
    `procs` and end this process with 1 at once."""
    if sys.exc_info()[0] is not None:
        traceback.print_exc(file=sys.stderr)
    print(f"benchmark: {message}; no result", file=sys.stderr, flush=True)
    for p in procs:
        p.kill()
    os._exit(1)


class Ranks:
    """Ranks 1..world-1 as children of this process (rank 0)."""

    def __init__(self, spec: dict, world: int, threads: int):
        self.spec, self.world, self.threads = spec, world, threads
        self.procs, self.replies = [], []
        self.stopping = False

    def start(self, device) -> None:
        """Start the children, join them in a new process group, and wait
        for each to have drawn its units."""
        import torch.distributed as dist

        port = free_port()
        backend = "nccl" if device.type == "cuda" else "gloo"
        path = [BENCH_DIR, ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                    if p]
        env = dict(os.environ, OMP_NUM_THREADS=str(self.threads),
                   PYTHONPATH=os.pathsep.join(path))
        for rank in range(1, self.world):
            spec = dict(self.spec, rank=rank, world=self.world, port=port, backend=backend,
                        device=device.type, timeout_s=GROUP_TIMEOUT_S)
            proc = subprocess.Popen(child_command(rank), stdin=subprocess.PIPE,
                                    stdout=subprocess.PIPE, env=env, cwd=ROOT, text=True)
            proc.stdin.write(json.dumps(spec) + "\n")
            proc.stdin.flush()
            replies = queue.Queue()
            self.procs.append(proc)
            self.replies.append(replies)
            threading.Thread(target=self._listen, args=(rank, proc, replies),
                             daemon=True).start()
        try:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=self.world, rank=0,
                                    timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        except Exception:
            fatal("the ranks did not join the process group", self.procs)
        self.collect()

    def _listen(self, rank, proc, replies) -> None:
        for line in proc.stdout:
            reply = json.loads(line)
            if "error" in reply:
                print(reply["error"], file=sys.stderr)
                fatal(f"rank {rank} failed", self.procs)
            replies.put(reply)
        if not self.stopping:
            fatal(f"rank {rank} ended with exit code {proc.wait()}", self.procs)

    def send(self, command: dict) -> None:
        line = json.dumps(command) + "\n"
        try:
            for proc in self.procs:
                proc.stdin.write(line)
                proc.stdin.flush()
        except OSError:
            fatal("a rank stopped taking commands", self.procs)

    def collect(self) -> list:
        """One reply from each child, in rank order."""
        out = []
        for rank, replies in enumerate(self.replies, start=1):
            try:
                out.append(replies.get(timeout=GROUP_TIMEOUT_S))
            except queue.Empty:
                fatal(f"rank {rank} sent nothing in {GROUP_TIMEOUT_S} s", self.procs)
        return out

    def fail(self, message: str) -> None:
        fatal(message, self.procs)

    def stop(self) -> None:
        """Stop the children and leave the process group."""
        import torch.distributed as dist

        self.stopping = True
        self.send({"op": "stop"})
        for proc in self.procs:
            proc.stdin.close()
        # every rank leaves the group at once, as the ranks of one job do
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def child_main() -> int:
    """A rank > 0: the spec on the first line of standard input, then one
    command a line; one reply a command on the original standard output
    (the program's own prints go to standard error)."""
    out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    spec = json.loads(sys.stdin.readline())
    commands, stopped = queue.Queue(), threading.Event()

    def listen():
        for line in sys.stdin:
            command = json.loads(line)
            if command["op"] == "stop":
                stopped.set()
            commands.put(command)
        if not stopped.is_set():
            os._exit(3)  # rank 0 is gone
        commands.put({"op": "stop"})

    threading.Thread(target=listen, daemon=True).start()
    import torch
    import torch.distributed as dist

    from benchlib import manifest
    from benchlib.assembly import unit_store
    from benchlib.simulate import draw_unit

    rank = int(spec["rank"])
    device = torch.device("cpu")
    if spec["device"] == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    driver = manifest.load_module("drivers", spec["driver"])
    try:
        dist.init_process_group(spec["backend"],
                                init_method=f"tcp://127.0.0.1:{spec['port']}",
                                world_size=int(spec["world"]), rank=rank,
                                timeout=datetime.timedelta(seconds=spec["timeout_s"]))
        seed, stream = int(spec["seed"]), spec["stream"]
        pool = [unit_store(draw_unit(seed, stream, k, spec["shapes"]))
                for k in range(int(spec["pool"]))]
        warmup = unit_store(draw_unit(seed, stream + "-warmup", 0, spec["warmup_shapes"]))
        out.write(json.dumps({"rank": rank, "ready": True}) + "\n")
        while True:
            command = commands.get()
            if command["op"] == "stop":
                break
            store = warmup if command["op"] == "warmup" else pool[int(command["k"])]
            (contigs, subreads), timings = driver.run_sample(store, spec["options"])
            out.write(json.dumps({"rank": rank, "timings": timings,
                                  "sha256": contig_digest(contigs, subreads),
                                  "peak_bytes": peak_bytes(device)}) + "\n")
    except Exception:
        out.write(json.dumps({"rank": rank, "error": traceback.format_exc()}) + "\n")
        os._exit(1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(child_main())

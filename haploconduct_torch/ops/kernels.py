"""Build, load and launch the hand-written CUDA kernels of the port.

Each source under `csrc/` (score_tasks.cu, join_verify.cu) is compiled
with nvcc for sm_90a into a shared library with a plain C interface and
bound with ctypes; both include csrc/lane_p.cuh. The build happens at
first use, into `build/torch_kernels/` at the root of the checkout
(listed in .gitignore), and again whenever the source or a header of
csrc/ is newer than the library;
`build_all` runs one nvcc per source at once. Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SCORE_SRC = _PKG / "csrc" / "score_tasks.cu"
JOIN_SRC = _PKG / "csrc" / "join_verify.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def default_group(rw: int) -> int:
    """Lanes of a warp that score one task together, by the matrix's row
    width, which bounds every task's length: 4 for reads (up to 256 bp), a
    warp for contigs. Each lane loads 16 bytes of each row per step.
    Measured on one H100 (PERF.md): of 1 to 32 lanes, 2 and 4 are the
    fastest at the read shapes (within 5% of each other), 32 at the
    kb-contig shapes."""
    return 4 if rw <= 256 else 32


_libs: dict = {}
# regions may be assembled on threads: loading and counting take this lock
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(src: Path) -> Path:
    """Compile `src` into BUILD_DIR/lib<stem>.so unless an up-to-date
    library is there; returns its path. Raises when nvcc fails. The
    compiler's resource report (-Xptxas -v) goes to BUILD_DIR/<stem>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{src.stem}.so"
    newest = max(f.stat().st_mtime for f in (src, *src.parent.glob("*.cuh")))
    if out.exists() and out.stat().st_mtime >= newest:
        return out
    # build to a temporary name and rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", str(src), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        (BUILD_DIR / f"{src.stem}.log").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all() -> list:
    """Build every kernel's library, one nvcc per source, all at once."""
    with ThreadPoolExecutor(max_workers=len(_ENTRY)) as pool:
        return list(pool.map(build, _ENTRY))


_p, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# each source's C entry point and its argument types
_ENTRY = {
    SCORE_SRC: ("hc_score_tasks", [_p, _i64, _p, _p, _p, _p, _i64, _f32, _i32,
                                   _i32, _p, _p, _p, _p, _p, _p]),
    JOIN_SRC: ("hc_join_verify", [_p, _i64, _p, _p, _p, _p, _p, _i64, _i32, _i32,
                                  _i32, _i32, _f32, _i32, _p, _p, _p]),
}


def load(src: Path = SCORE_SRC):
    """Build (if needed) and load the library of `src` once per process;
    returns its C entry point."""
    with _lock:
        fn = _libs.get(src)
        if fn is None:
            name, argtypes = _ENTRY[src]
            fn = getattr(ctypes.CDLL(str(build(src))), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[src] = fn
    return fn


def _launch(fn, dev: torch.device, args) -> int:
    """Call a C entry point with `dev` as the current device: a kernel
    launches on the current device."""
    if dev.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def score_tasks_cuda(comb: torch.Tensor, lens: torch.Tensor, row_a: torch.Tensor,
                     row_b: torch.Tensor, pos: torch.Tensor,
                     mismatch_thresh: float, group: int = 0):
    """Launch the scoring kernel on the current stream of comb's device.

    comb: (R, RW) int16 code | qual << 3 words, RW a multiple of 8 and the
    storage 16-byte aligned (ops/score.py:pack_for_device); lens: (R,)
    int32 row lengths <= RW; row_a, row_b, pos: (n,) int32 task columns.
    Returns per task (sum_log f64, counted i32, mismatches i32, rejected
    i32). The caller guarantees row ids in range and pos >= 0
    (ops/score.py:check_tasks checks). `group` (4 or 32) picks the
    lanes per task (0: default_group of the row width). The kernel's
    table is sized by the largest phred in comb, read here on the card
    (the host waits for that read). Raises on a refused launch."""
    group = group or default_group(comb.shape[1])
    if group not in (4, 32):
        raise ValueError("group must be 4 or 32")
    if (not comb.is_cuda or comb.dtype != torch.int16 or comb.dim() != 2
            or not comb.is_contiguous() or comb.shape[1] % 8
            or comb.data_ptr() % 16):
        raise ValueError("comb must be a contiguous 2-D int16 CUDA tensor, "
                         "16-byte aligned, with rows of a multiple of 8 words")
    n = row_a.shape[0]
    if (lens.device != comb.device or lens.dtype != torch.int32
            or lens.shape != (comb.shape[0],)):
        raise ValueError("lens must be (R,) int32 on comb's device")
    cols = (row_a, row_b, pos)
    for c in cols:
        if (c.device != comb.device or c.dtype != torch.int32
                or c.dim() != 1 or c.shape[0] != n):
            raise ValueError("task columns must be (n,) int32 on comb's device")
    lens = lens.contiguous()
    cols = tuple(c.contiguous() for c in cols)
    dev = comb.device
    sum_log, ints = score_tasks_outputs(n, dev)
    if n:
        # the table covers phreds up to this one; a lower value would let
        # lanes index past it
        max_qual = int(comb.max()) >> 3
        launch_score_tasks(comb, lens, *cols, mismatch_thresh, max_qual, group,
                           sum_log, ints)
    return sum_log, ints[:n], ints[n:2 * n], ints[2 * n:3 * n]


score_tasks_cuda.launches = 0


def score_tasks_outputs(n: int, dev):
    """The scoring kernel's outputs for n tasks: sum_log (n,) f64 and one
    (3n + 1,) int32 block of counted, mismatches, rejected and the
    kernel's tile counter."""
    return (torch.empty(n, dtype=torch.float64, device=dev),
            torch.empty(3 * n + 1, dtype=torch.int32, device=dev))


def launch_score_tasks(comb, lens, row_a, row_b, pos, mismatch_thresh: float,
                       max_qual: int, group: int, sum_log, ints, fn=None) -> None:
    """Enqueue one launch of the scoring kernel on the current stream of
    comb's device, into score_tasks_outputs' tensors, and count it in
    score_tasks_cuda.launches. No check and no host wait: the caller gives
    contiguous int32 columns on comb's device and max_qual >= the largest
    phred in comb. `fn` is a C entry point of the same interface (default:
    the built csrc/score_tasks.cu). A launch recorded into a CUDA graph is
    not counted here: it runs, and is counted, where the graph is replayed
    (count_score_tasks_launches)."""
    n = row_a.shape[0]
    dev = comb.device
    args = (comb.data_ptr(), comb.shape[1], lens.data_ptr(), row_a.data_ptr(),
            row_b.data_ptr(), pos.data_ptr(), n, float(mismatch_thresh), int(max_qual),
            int(group), ints[3 * n:].data_ptr(), sum_log.data_ptr(),
            ints[:n].data_ptr(), ints[n:2 * n].data_ptr(), ints[2 * n:3 * n].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    err = _launch(fn or load(SCORE_SRC), dev, args)
    if err != 0:
        raise RuntimeError(f"score_tasks kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        count_score_tasks_launches(1)


def count_score_tasks_launches(k: int) -> None:
    with _lock:
        score_tasks_cuda.launches += k


def join_verify_cuda(comb: torch.Tensor, lens: torch.Tensor, t_rid: torch.Tensor,
                     t_pos: torch.Tensor, left: torch.Tensor, count: torch.Tensor,
                     row0: int, nk: int, expand: int, min_overlap_len: int,
                     edge_threshold: float):
    """Launch the fused join + verify kernel on the current stream of
    comb's device.

    comb: (R, RW) int16 code | qual << 3 words (ops/score.py:
    pack_for_device); lens: (R,) int32; t_rid, t_pos: (T,) int32, the
    sorted k-mer table; left, count: (n,) int32 per query k-mer of rows
    row0 .. row0 + n / nk. Returns (scores (n * expand,) f32 in slot
    order, n_edges (1,) int32). The caller guarantees every index in range
    (ops/join_verify.py builds them). A block takes a query row, finds the
    distinct diagonals among its slots and scores each once with a warp.
    The kernel's table is sized by the largest phred in comb, read here on
    the card. Raises on a refused launch."""
    if (not comb.is_cuda or comb.dtype != torch.int16 or comb.dim() != 2
            or not comb.is_contiguous()):
        raise ValueError("comb must be a contiguous 2-D int16 CUDA tensor")
    n = left.shape[0]
    if n % nk or row0 < 0 or row0 + n // nk > comb.shape[0]:
        raise ValueError("the queries must be whole rows of comb")
    # a diagonal's key rb * nk + shift and a row's slot index are int32
    if comb.shape[0] * nk >= 2**31 or nk * expand >= 2**31 - 4096:
        raise ValueError("the join needs R * NK and NK * expand below 2^31")
    if lens.shape != (comb.shape[0],) or t_rid.shape != t_pos.shape \
            or count.shape != left.shape:
        raise ValueError("lens must be (R,), the table and query columns alike")
    for c in (lens, t_rid, t_pos, left, count):
        if c.device != comb.device or c.dtype != torch.int32 or c.dim() != 1:
            raise ValueError("lens, table and query columns must be 1-D int32 "
                             "on comb's device")
    lens, t_rid, t_pos, left, count = (c.contiguous() for c in
                                       (lens, t_rid, t_pos, left, count))
    dev = comb.device
    scores = torch.empty(n * expand, dtype=torch.float32, device=dev)
    n_edges = torch.zeros(1, dtype=torch.int32, device=dev)
    if n == 0 or expand == 0:
        return scores, n_edges
    max_qual = int(comb.max()) >> 3
    args = (comb.data_ptr(), comb.shape[1], lens.data_ptr(), t_rid.data_ptr(),
            t_pos.data_ptr(), left.data_ptr(), count.data_ptr(), n, int(row0),
            int(nk), int(expand), int(min_overlap_len), float(edge_threshold),
            max_qual, scores.data_ptr(), n_edges.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    err = _launch(load(JOIN_SRC), dev, args)
    if err != 0:
        raise RuntimeError(f"join_verify kernel launch failed: CUDA error {err}")
    with _lock:
        join_verify_cuda.launches += 1
    return scores, n_edges


join_verify_cuda.launches = 0

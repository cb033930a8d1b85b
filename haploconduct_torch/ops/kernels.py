"""Build, load and launch the hand-written CUDA kernels of the port.

`csrc/score_segments.cu` is compiled with nvcc for sm_90a into a shared
library with a plain C interface and bound with ctypes. The build happens
at first use, into `build/torch_kernels/` at the root of the checkout
(listed in .gitignore), and again whenever the source is newer than the
library. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SCORE_SRC = _PKG / "csrc" / "score_segments.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}


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
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
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


def load() -> ctypes.CDLL:
    """Build (if needed) and load the scoring kernel's library once per
    process."""
    lib = _libs.get("score")
    if lib is None:
        lib = ctypes.CDLL(str(build(SCORE_SRC)))
        fn = lib.hc_score_segments
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int64, p, p, p, p, ctypes.c_int64,
                       ctypes.c_float, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _libs["score"] = lib
    return lib


def score_segments_cuda(comb: torch.Tensor, rowa: torch.Tensor,
                        rowb: torch.Tensor, posa: torch.Tensor,
                        bolen: torch.Tensor, mismatch_thresh: float):
    """Launch the scoring kernel on the current stream of comb's device.

    comb: (R, rw) int16 code | qual << 3 words; rowa/rowb/posa/bolen:
    (n,) int32 subtask columns (ops/score.py:segment_tasks layout). Returns
    (sum_log f32, counted i32, mismatches i32, rejected i32), each (n,).
    The caller guarantees posa + seg_len and k * SEG + seg_len stay within
    the rows' lengths (segment_tasks does). Raises on a refused launch."""
    cols = (rowa, rowb, posa, bolen)
    if not comb.is_cuda or comb.dtype != torch.int16 or comb.dim() != 2:
        raise ValueError("comb must be a 2-D int16 CUDA tensor")
    n = rowa.shape[0]
    for c in cols:
        if (c.device != comb.device or c.dtype != torch.int32
                or c.dim() != 1 or c.shape[0] != n):
            raise ValueError("subtask columns must be (n,) int32 on comb's device")
    comb = comb.contiguous()
    cols = tuple(c.contiguous() for c in cols)
    dev = comb.device
    sum_log = torch.empty(n, dtype=torch.float32, device=dev)
    counted, mism, rej = (torch.empty(n, dtype=torch.int32, device=dev)
                          for _ in range(3))
    if n == 0:
        return sum_log, counted, mism, rej
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hc_score_segments(
            comb.data_ptr(), comb.shape[1], *(c.data_ptr() for c in cols), n,
            float(mismatch_thresh), sum_log.data_ptr(), counted.data_ptr(),
            mism.data_ptr(), rej.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"score_segments kernel launch failed: CUDA error {err}")
    score_segments_cuda.launches += 1
    return sum_log, counted, mism, rej


score_segments_cuda.launches = 0

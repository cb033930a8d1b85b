"""Native C++ extensions, compiled on demand with g++ (no pybind11).

Extensions are cached next to their sources as _<name>.so and rebuilt when
the source is newer. Loading failures degrade gracefully to the Python
fallbacks in the calling modules.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))


def _build_ext(name: str, sources) -> str:
    so_path = os.path.join(_DIR, f"_{name}.so")
    src_paths = [os.path.join(_DIR, s) for s in sources]
    if os.path.exists(so_path) and all(
        os.path.getmtime(so_path) >= os.path.getmtime(s) for s in src_paths
    ):
        return so_path
    include = sysconfig.get_paths()["include"]
    # Compile to a temp file and os.replace() into place so concurrent
    # builders (parallel test workers, region pools) never dlopen a
    # half-written .so; replace is atomic within one filesystem.
    fd, tmp_path = tempfile.mkstemp(suffix=".so", prefix=f"_{name}_",
                                    dir=_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", f"-I{include}", *src_paths, "-o", tmp_path,
    ]
    try:
        subprocess.check_call(cmd)
        os.replace(tmp_path, so_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return so_path


class _CliquesExt:
    def __init__(self, module):
        self._m = module

    def enumerate_cliques(self, n: int, v1: np.ndarray, v2: np.ndarray):
        flat_b, off_b = self._m.enumerate_cliques_raw(
            n, np.ascontiguousarray(v1, dtype=np.int64),
            np.ascontiguousarray(v2, dtype=np.int64))
        flat = np.frombuffer(flat_b, dtype=np.int64)
        offsets = np.frombuffer(off_b, dtype=np.int64)
        return flat, offsets


class _BaselineExt:
    def __init__(self, module):
        self._m = module

    def score_tasks(self, codes, quals, lens, row_a, row_b, pos, mismatch_thresh=0.0):
        n = len(row_a)
        score_b, mism_b = self._m.score_tasks(
            np.ascontiguousarray(codes, dtype=np.int8),
            np.ascontiguousarray(quals, dtype=np.uint8),
            np.ascontiguousarray(lens, dtype=np.int32),
            int(codes.shape[1]),
            np.ascontiguousarray(row_a, dtype=np.int32),
            np.ascontiguousarray(row_b, dtype=np.int32),
            np.ascontiguousarray(pos, dtype=np.int32),
            n, float(mismatch_thresh))
        return (np.frombuffer(score_b, dtype=np.float64),
                np.frombuffer(mism_b, dtype=np.float64))

    def score_tasks_exact(self, codes, quals, lens, row_a, row_b, pos,
                          mismatch_thresh, min_read_len, luts):
        """Full TaskScores contract (see ops/score.py): returns
        (score, mismatch_rate, sum_log, counted, mismatches, rejected).
        `luts` is the _pair_luts() tuple (p_match, p_mis, log_match, log_mis)."""
        n = len(row_a)
        lm, lx, llm, llx = (np.ascontiguousarray(t, dtype=np.float64) for t in luts)
        out = self._m.score_tasks_exact(
            np.ascontiguousarray(codes, dtype=np.int8),
            np.ascontiguousarray(quals, dtype=np.uint8),
            np.ascontiguousarray(lens, dtype=np.int32),
            int(codes.shape[1]),
            np.ascontiguousarray(row_a, dtype=np.int32),
            np.ascontiguousarray(row_b, dtype=np.int32),
            np.ascontiguousarray(pos, dtype=np.int32),
            n, float(mismatch_thresh), int(min_read_len), lm, lx, llm, llx)
        score_b, mrate_b, sumlog_b, counted_b, mism_b, rej_b = out
        return (np.frombuffer(score_b, dtype=np.float64),
                np.frombuffer(mrate_b, dtype=np.float64),
                np.frombuffer(sumlog_b, dtype=np.float64),
                np.frombuffer(counted_b, dtype=np.int64),
                np.frombuffer(mism_b, dtype=np.int64),
                np.frombuffer(rej_b, dtype=np.uint8).astype(bool))


_baseline_ext: Optional[_BaselineExt] = None
_baseline_failed = False


def load_baseline_ext() -> Optional[_BaselineExt]:
    global _baseline_ext, _baseline_failed
    if _baseline_ext is not None or _baseline_failed:
        return _baseline_ext
    try:
        import importlib.util

        so_path = _build_ext("baseline_score", ["baseline_score.cpp"])
        spec = importlib.util.spec_from_file_location("_baseline_score", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _baseline_ext = _BaselineExt(module)
    except Exception:
        _baseline_failed = True
        _baseline_ext = None
    return _baseline_ext


class _RefsemExt:
    def __init__(self, module):
        self._m = module

    def umap_order(self, keys) -> np.ndarray:
        """Iteration order of a libstdc++ std::unordered_map whose keys were
        inserted in first-appearance order of `keys`."""
        arr = np.ascontiguousarray(keys, dtype=np.uint64)
        return np.frombuffer(self._m.umap_order(arr), dtype=np.uint64)

    def enumerate_cliques_ref(self, n: int, u: np.ndarray, v: np.ndarray):
        flat_b, off_b = self._m.enumerate_cliques_ref_raw(
            int(n), np.ascontiguousarray(u, dtype=np.int64),
            np.ascontiguousarray(v, dtype=np.int64))
        flat = np.frombuffer(flat_b, dtype=np.int64)
        offsets = np.frombuffer(off_b, dtype=np.int64)
        return flat, offsets


_refsem_ext: Optional[_RefsemExt] = None
_refsem_failed = False


def load_refsem_ext() -> Optional[_RefsemExt]:
    global _refsem_ext, _refsem_failed
    if _refsem_ext is not None or _refsem_failed:
        return _refsem_ext
    try:
        import importlib.util

        so_path = _build_ext("refsem", ["refsem.cpp"])
        spec = importlib.util.spec_from_file_location("_refsem", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _refsem_ext = _RefsemExt(module)
    except Exception:
        _refsem_failed = True
        _refsem_ext = None
    return _refsem_ext


class _ConsensusExt:
    def __init__(self, module):
        self._m = module

    def consensus_scatter(self, seq_cat, qual_cat, src0, dst0, wlen,
                          job_start, w_total, l_match_lut, l_mis_lut,
                          min_qual, n_code, n_qual):
        """Pass-2 consensus over flat member windows (see batch_consensus):
        returns (codes int8, quals uint8, counts int64) of length w_total."""
        nj = len(job_start) - 1
        codes_b, quals_b, counts_b = self._m.consensus_scatter(
            np.ascontiguousarray(seq_cat, dtype=np.int8),
            np.ascontiguousarray(qual_cat, dtype=np.uint8),
            np.ascontiguousarray(src0, dtype=np.int64),
            np.ascontiguousarray(dst0, dtype=np.int64),
            np.ascontiguousarray(wlen, dtype=np.int64),
            np.ascontiguousarray(job_start, dtype=np.int64),
            nj, int(w_total),
            np.ascontiguousarray(l_match_lut, dtype=np.float64),
            np.ascontiguousarray(l_mis_lut, dtype=np.float64),
            float(min_qual), int(n_code), int(n_qual))
        return (np.frombuffer(codes_b, dtype=np.int8),
                np.frombuffer(quals_b, dtype=np.uint8),
                np.frombuffer(counts_b, dtype=np.int64))


_consensus_ext: Optional[_ConsensusExt] = None
_consensus_failed = False


def load_consensus_ext() -> Optional[_ConsensusExt]:
    global _consensus_ext, _consensus_failed
    if _consensus_ext is not None or _consensus_failed:
        return _consensus_ext
    try:
        import importlib.util

        so_path = _build_ext("consensus", ["consensus.cpp"])
        spec = importlib.util.spec_from_file_location("_consensus", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _consensus_ext = _ConsensusExt(module)
    except Exception:
        _consensus_failed = True
        _consensus_ext = None
    return _consensus_ext


class _KmerJoinExt:
    def __init__(self, module):
        self._m = module

    def join_unique(self, q_sid, q_pos, left, count, t_sid, t_pos, rev,
                    lens, min_ov=0):
        """Expand hash-group ranges into sorted unique packed candidate
        keys (same packing as ops/kmer._pack_keys). With min_ov > 0,
        candidates below that overlap length in the query frame are
        dropped at emission (the caller's post-unpack filter, hoisted)."""
        keys_b = self._m.join_unique(
            np.ascontiguousarray(q_sid, dtype=np.int64),
            np.ascontiguousarray(q_pos, dtype=np.int64),
            np.ascontiguousarray(left, dtype=np.int64),
            np.ascontiguousarray(count, dtype=np.int64),
            len(q_sid),
            np.ascontiguousarray(t_sid, dtype=np.int64),
            np.ascontiguousarray(t_pos, dtype=np.int64), int(rev),
            np.ascontiguousarray(lens, dtype=np.int64), int(min_ov))
        return np.frombuffer(keys_b, dtype=np.int64)

    def canonicalize_keys(self, keys, lens, drop_inclusions=False):
        """Map unique query-frame candidate keys to the sorted unique
        canonical (idA < idB) key set (ops/kmer.py swap algebra)."""
        out_b = self._m.canonicalize_keys(
            np.ascontiguousarray(keys, dtype=np.int64), len(keys),
            np.ascontiguousarray(lens, dtype=np.int64),
            int(bool(drop_inclusions)))
        return np.frombuffer(out_b, dtype=np.int64)

    def diag_mismatch(self, codes, lens, row_first, row_second, pos,
                      error_rate):
        """Per-candidate gapless diagonal (counted, mismatches). Counts may
        be partial for candidates that provably exceed the error budget
        (early reject) — the caller's keep mask is unaffected."""
        n = len(row_first)
        counted_b, mism_b = self._m.diag_mismatch(
            np.ascontiguousarray(codes, dtype=np.int8),
            np.ascontiguousarray(lens, dtype=np.int64),
            int(codes.shape[1]),
            np.ascontiguousarray(row_first, dtype=np.int64),
            np.ascontiguousarray(row_second, dtype=np.int64),
            np.ascontiguousarray(pos, dtype=np.int64), n, float(error_rate))
        return (np.frombuffer(counted_b, dtype=np.int64),
                np.frombuffer(mism_b, dtype=np.int64))


_kmerjoin_ext: Optional[_KmerJoinExt] = None
_kmerjoin_failed = False


def load_kmerjoin_ext() -> Optional[_KmerJoinExt]:
    global _kmerjoin_ext, _kmerjoin_failed
    if _kmerjoin_ext is not None or _kmerjoin_failed:
        return _kmerjoin_ext
    try:
        import importlib.util

        so_path = _build_ext("kmerjoin", ["kmerjoin.cpp"])
        spec = importlib.util.spec_from_file_location("_kmerjoin", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _kmerjoin_ext = _KmerJoinExt(module)
    except Exception:
        _kmerjoin_failed = True
        _kmerjoin_ext = None
    return _kmerjoin_ext


_cliques_ext: Optional[_CliquesExt] = None
_cliques_failed = False


def load_cliques_ext() -> Optional[_CliquesExt]:
    global _cliques_ext, _cliques_failed
    if _cliques_ext is not None or _cliques_failed:
        return _cliques_ext
    try:
        import importlib.util

        so_path = _build_ext("cliques", ["cliques.cpp"])
        spec = importlib.util.spec_from_file_location("_cliques", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _cliques_ext = _CliquesExt(module)
    except Exception:
        _cliques_failed = True
        _cliques_ext = None
    return _cliques_ext


class _TransitiveExt:
    def __init__(self, module):
        self._m = module

    def transitive_mask(self, out_ptr, out_idx, in_ptr, in_idx, q1, q2):
        """mask[i] = 1 iff a 2-path q1[i] -> x -> q2[i] exists; CSR
        adjacency lists must be sorted."""
        mask_b = self._m.transitive_mask(
            np.ascontiguousarray(out_ptr, dtype=np.int64),
            np.ascontiguousarray(out_idx, dtype=np.int64),
            np.ascontiguousarray(in_ptr, dtype=np.int64),
            np.ascontiguousarray(in_idx, dtype=np.int64),
            np.ascontiguousarray(q1, dtype=np.int64),
            np.ascontiguousarray(q2, dtype=np.int64), len(q1))
        return np.frombuffer(mask_b, dtype=np.uint8).astype(bool)


class _BfsLabelExt:
    def __init__(self, module):
        self._m = module

    def bfs_label(self, start_ptr, merged_nb, merged_sm, rands, starts,
                  orientations, visited, comp, maxdeg):
        """Seeded-shuffle BFS labelling; orientations/visited/comp are
        written IN PLACE (must be contiguous bool/bool/int64 arrays).
        `comp` may be None (component recording disabled)."""
        n = len(orientations)
        use_comp = comp is not None
        if comp is None:
            comp = _DUMMY_COMP
        self._m.bfs_label(
            np.ascontiguousarray(start_ptr, dtype=np.int64),
            np.ascontiguousarray(merged_nb, dtype=np.int64),
            merged_sm, rands,
            np.ascontiguousarray(starts, dtype=np.int64),
            orientations, visited, comp, int(use_comp), n, int(maxdeg))


_DUMMY_COMP = np.zeros(1, dtype=np.int64)
_bfslabel_ext: Optional[_BfsLabelExt] = None
_bfslabel_failed = False


def load_bfslabel_ext() -> Optional[_BfsLabelExt]:
    global _bfslabel_ext, _bfslabel_failed
    if _bfslabel_ext is not None or _bfslabel_failed:
        return _bfslabel_ext
    try:
        import importlib.util

        so_path = _build_ext("bfslabel", ["bfslabel.cpp"])
        spec = importlib.util.spec_from_file_location("_bfslabel", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _bfslabel_ext = _BfsLabelExt(module)
    except Exception:
        _bfslabel_failed = True
        _bfslabel_ext = None
    return _bfslabel_ext


_transitive_ext: Optional[_TransitiveExt] = None
_transitive_failed = False


def load_transitive_ext() -> Optional[_TransitiveExt]:
    global _transitive_ext, _transitive_failed
    if _transitive_ext is not None or _transitive_failed:
        return _transitive_ext
    try:
        import importlib.util

        so_path = _build_ext("transitive", ["transitive.cpp"])
        spec = importlib.util.spec_from_file_location("_transitive", so_path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _transitive_ext = _TransitiveExt(module)
    except Exception:
        _transitive_failed = True
        _transitive_ext = None
    return _transitive_ext

"""POLYTE workflow: diploid/polyploid haplotig assembly at low coverage.

In-memory rebuild of the reference polyte.py:
- preprocessing concatenates singles + /1 + /2 into one single-end read set
  renamed 0..N-1 (polyte.py:275-305);
- candidate overlaps via the k-mer engine at min_overlap_len_EC =
  2 + 0.5 * readlen (polyte.py:258-266), verified at the sfo error rate;
- evidence threshold table (workflows/min_ev_table.py) from read length,
  internal segment size and haplotype coverage (polyte.py:804-830);
- iteration scheme (polyte.py:574-673): one EC clique iteration
  (edge_threshold 0.95), then loop { merge iterations (cliques=false,
  edge_threshold=1 => mismatch-rate-only edges) until read count stable;
  one BranchReduction clique iteration } until converged, plus a final
  cleanup iteration. Unlike SAVAGE, overlaps are RECOMPUTED on the contigs
  every iteration (exact, sfo_err=0) instead of FNO-induced
  (polyte.py:739-746);
- optional diploid round re-runs the loop with --diploid and subreads
  carry-over (polyte.py:376-423).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.reads import ReadStore
from ..io.sfo import sfo_to_overlaps
from ..io.subreads import SubreadDict
from ..ops.kmer import find_overlap_candidates
from ..parallel.devices import on_card
from ..utils.config import Settings
from ..assemble.iteration import run_iteration
from ..io.overlaps import empty_overlaps
from .min_ev_table import build_threshold_table


@dataclass
class PolyteConfig:
    hap_cov: float = 0.0  # >0 enables read-based branch reduction
    insert_size: float = 0.0  # required
    stddev: float = 0.0  # required
    min_overlap_len: int = 50
    min_overlap_len_EC: Optional[int] = None  # default 2 + 0.5*readlen
    merge_contigs: float = 0.0  # --mismatch_rate
    min_clique_size: int = 3
    sfo_err: float = 0.02
    error_correction: bool = True
    diploid: bool = False
    diploid_contig_len: int = 0
    diploid_overlap_len: Optional[int] = None
    average_read_len: Optional[float] = None
    max_tip_len: Optional[int] = None
    original_SE_count: int = -1  # split mode
    original_PE_count: int = -1
    backend: str = "auto"
    kmer_k: int = 20
    # per-iteration re-overlap engine: "auto" uses the torch sort-join
    # (ops/kmer_device.py) on the card for exact passes when a card is
    # present, the host k-mer join otherwise; "host"/"device" force one
    candidates: str = "auto"
    verbose: bool = False


@dataclass
class PolyteResult:
    store: Optional[ReadStore]
    subreads: Optional[SubreadDict]
    diploid_store: Optional[ReadStore] = None
    diploid_subreads: Optional[SubreadDict] = None
    iterations: int = 0
    history: List[dict] = field(default_factory=list)


def concat_to_single_end(store: ReadStore) -> ReadStore:
    """cat singles + paired1 + paired2 -> renamed single-end store
    (polyte.py:281-290)."""
    out = ReadStore()
    ns = store.readcount_single
    npair = len(store) - ns
    nid = 0
    for i in range(ns):
        u1, _ = store.units_of(i)
        out.add_single_codes(nid, store.unit_codes(u1), store.unit_quals(u1))
        nid += 1
    for j in range(npair):
        u1, _ = store.units_of(ns + j)
        out.add_single_codes(nid, store.unit_codes(u1), store.unit_quals(u1))
        nid += 1
    for j in range(npair):
        _, u2 = store.units_of(ns + j)
        out.add_single_codes(nid, store.unit_codes(u2), store.unit_quals(u2))
        nid += 1
    out.readcount_single = nid
    return out


def _device_candidates_ok(min_overlap_len: int, sfo_err: float, n: int) -> bool:
    """The device join (ops/kmer_device.py, k<=15) provably finds the same
    verified candidate set as the host engine (k=20) only for EXACT
    re-overlap passes: with error_rate=0 every surviving candidate is a
    0-mismatch diagonal overlap of length >= min_overlap_len, and any such
    overlap contains exact k-mers for both k=15 and k=20 at full seed
    density — so the two engines' verified outputs coincide whenever
    min_overlap_len >= 20 (above 1500 sequences the host engine subsamples
    seeds, so there the device set is the *complete* one and the host's a
    documented-miss-rate subset). Approximate passes (sfo_err > 0)
    seed-match differently between k=15 and k=20, so those stay on the
    host engine."""
    return sfo_err == 0.0 and min_overlap_len >= 20 and 0 < n < (1 << 16)


def _resolve_engine(engine: str, min_overlap_len: int, sfo_err: float,
                    n: int) -> str:
    """The device join when named; under "auto", when it provably agrees
    with the host engine and the torch backend runs on a card (the
    reference's rule: the join goes to the device only on an
    accelerator)."""
    if engine == "device" or (engine == "auto" and on_card()
                              and _device_candidates_ok(min_overlap_len, sfo_err, n)):
        return "device"
    return "host"


def single_end_candidates(store: ReadStore, min_overlap_len: int, sfo_err: float,
                          k: int = 20, engine: str = "host") -> np.ndarray:
    seqs = [store.unit_codes(store.unit1[i]) for i in range(len(store))]
    if _resolve_engine(engine, min_overlap_len, sfo_err, len(seqs)) == "device":
        # the torch sort-join on the torch backend's device, at its default
        # k=15; identical verified output to the host engine (k=20) for
        # exact passes (see _device_candidates_ok)
        from ..ops.kmer_device import find_overlap_candidates_device

        sfo = find_overlap_candidates_device(
            seqs, min_overlap_len=min_overlap_len, error_rate=sfo_err, verify=True)
    else:
        # Seed density: the initial read-scale join (thousands of sequences,
        # S = m-k+1 >> 80 shared k-mers per true overlap) safely uses
        # content-based subsampling; later contig-scale iterations (smaller
        # stores, mismatch-rate merging sensitive to individual candidates)
        # keep full density.
        subsample = None if len(seqs) > 1500 else 1
        sfo = find_overlap_candidates(seqs, min_overlap_len=min_overlap_len,
                                      k=k, error_rate=sfo_err, verify=True,
                                      subsample=subsample)
    ov = sfo_to_overlaps(sfo, num_singles=len(seqs), num_pairs=0)
    # candidate ids are positional; remap to the store's actual read ids
    # (differs in split mode, where region stores keep global ids)
    ids = np.asarray(store.ids, dtype=np.uint64)
    if len(ov) and not np.array_equal(ids, np.arange(len(ids), dtype=np.uint64)):
        ov["id1"] = ids[ov["id1"].astype(np.int64)]
        ov["id2"] = ids[ov["id2"].astype(np.int64)]
    return ov


class _AssemblyLoop:
    """run_savage_assembly (polyte.py:574-673) over in-memory state."""

    def __init__(self, cfg: PolyteConfig, original_store: ReadStore,
                 thresholds: Dict[int, int], SE_count: int, PE_count: int,
                 original_readcount: int, max_tip_len: int, mol_ec: int):
        self.cfg = cfg
        self.original_store = original_store
        self.thresholds = thresholds
        self.SE_count = SE_count
        self.PE_count = PE_count
        self.original_readcount = original_readcount
        self.max_tip_len = max_tip_len
        self.mol_ec = mol_ec
        self.iteration = 0
        self.history: List[dict] = []

    def _settings(self, *, first_it: bool, cliques: bool, EC: bool,
                  min_clique_size: int, edge_threshold: float,
                  min_overlap_len: int, branch_red: bool, error_rate: float,
                  diploid: bool, final_it: bool) -> Settings:
        # flag derivations mirror polyte.py run_viralquasispecies:676-735
        if EC:
            keep_singletons = 1000
        elif diploid and final_it:
            keep_singletons = self.max_tip_len
        else:
            keep_singletons = 0
        remove_trans = 2 if EC else 1
        remove_branches = (not cliques) or (not EC and not branch_red)
        return Settings(
            min_overlap_len=min_overlap_len,
            edge_threshold=edge_threshold,
            first_it=first_it,
            cliques=cliques,
            error_correction=EC,
            keep_singletons=keep_singletons,
            min_clique_size=min_clique_size,
            remove_branches=remove_branches,
            remove_tips=False,
            merge_contigs=error_rate,
            fno=1,
            original_readcount=self.original_readcount,
            remove_trans=remove_trans,
            optimize=False,
            min_read_len=0,
            max_tip_len=self.max_tip_len,
            store_tips_separately=final_it,
            ignore_inclusions=final_it and diploid,
            diploid=diploid,
            min_qual=0.0,  # never insert N's
            branch_reduction=branch_red,
            branch_SE_c=self.SE_count,
            branch_PE_c=self.PE_count // 2,
            backend=self.cfg.backend,
            verbose=self.cfg.verbose,
        )

    def run(self, store: ReadStore, overlaps: np.ndarray,
            subreads: Optional[SubreadDict], *, EC: bool, diploid: bool,
            min_overlap_len: int, min_clique_size: int, error_rate: float):
        cfg = self.cfg
        state = dict(store=store, subreads=subreads, overlaps=overlaps)
        read_counts = [self.original_readcount]
        overlap_counts = [len(overlaps)]
        edge_counts: List[int] = [1]
        # Loop semantics mirror the reference exactly (polyte.py:616-640):
        # a 0-edge iteration exits the binary BEFORE writing outputs, so the
        # previous contig/overlap files stay in place and the unconditional
        # BranchReduction iteration (and the final cleanup) still run on
        # that stale state. Until the first successful iteration no
        # singles.fastq exists at all, so read_counts records 0.
        produced = [False]

        def step(settings: Settings, final_it: bool = False) -> None:
            self.iteration += 1
            res = run_iteration(
                state["store"], state["overlaps"], settings, state["subreads"],
                original_store=self.original_store if settings.branch_reduction else None,
                threshold_table=self.thresholds if settings.branch_reduction else None,
            )
            self.history.append(dict(iteration=self.iteration, **res.stats))
            if res.terminated:
                read_counts.append(len(state["store"]) if produced[0] else 0)
                overlap_counts.append(len(state["overlaps"]) if produced[0] else 0)
                edge_counts.append(-2)
                return
            produced[0] = True
            state["store"], state["subreads"] = res.store, res.subreads
            if len(res.store) > 0:
                state["overlaps"] = single_end_candidates(
                    res.store, min_overlap_len, 0.0, cfg.kmer_k,
                    engine=cfg.candidates)
            else:
                state["overlaps"] = empty_overlaps(0)
            read_counts.append(len(res.store))
            overlap_counts.append(len(state["overlaps"]))
            edge_counts.append(res.stats.get("n_edges_final", 0))

        branch_red_on = cfg.hap_cov > 0
        if EC:
            step(self._settings(
                first_it=True, cliques=True, EC=True,
                min_clique_size=min_clique_size, edge_threshold=0.95,
                min_overlap_len=self.mol_ec, branch_red=False,
                error_rate=error_rate, diploid=diploid, final_it=False))
        elif diploid:
            step(self._settings(
                first_it=False, cliques=True, EC=False,
                min_clique_size=min_clique_size, edge_threshold=1.0,
                min_overlap_len=min_overlap_len, branch_red=branch_red_on,
                error_rate=error_rate, diploid=diploid, final_it=False))
        else:
            step(self._settings(
                first_it=True, cliques=True, EC=False,
                min_clique_size=min_clique_size, edge_threshold=0.95,
                min_overlap_len=self.mol_ec, branch_red=False,
                error_rate=error_rate, diploid=diploid, final_it=False))

        merge_s = self._settings(
            first_it=False, cliques=False, EC=False, min_clique_size=2,
            edge_threshold=1.0, min_overlap_len=min_overlap_len,
            branch_red=False, error_rate=error_rate, diploid=diploid,
            final_it=False)
        br_s = self._settings(
            first_it=False, cliques=True, EC=False, min_clique_size=2,
            edge_threshold=1.0, min_overlap_len=min_overlap_len,
            branch_red=branch_red_on, error_rate=error_rate, diploid=diploid,
            final_it=False)

        const_read_its = 0
        while read_counts[-1] > 0 and overlap_counts[-1] > 0 \
                and edge_counts[-1] > 0 and const_read_its < 2:
            while read_counts[-1] > 0 and overlap_counts[-1] > 0 \
                    and edge_counts[-1] > 0 and const_read_its < 2:
                step(merge_s)
                const_read_its = const_read_its + 1 if read_counts[-1] == read_counts[-2] else 0
            step(br_s)
            const_read_its = const_read_its + 1 if read_counts[-1] == read_counts[-2] else 0

        if read_counts[-1] > 0:
            final_s = self._settings(
                first_it=False, cliques=False, EC=False, min_clique_size=2,
                edge_threshold=1.0, min_overlap_len=min_overlap_len,
                branch_red=False, error_rate=error_rate, diploid=diploid,
                final_it=True)
            step(final_s, final_it=True)
        if not produced[0]:
            return None, None
        return state["store"], state["subreads"]


def run_polyte(store: ReadStore, cfg: PolyteConfig,
               preprocessing: bool = True,
               original_store: Optional[ReadStore] = None,
               initial_overlaps: Optional[np.ndarray] = None) -> PolyteResult:
    """`preprocessing=False` takes `store` as the already-renamed single-end
    read set (polyte --no_preprocessing, used per region by polyte-split);
    `original_store` overrides the evidence read set for branch reduction
    (split mode passes the full-genome read set, polyte-split.py:505-517);
    `initial_overlaps` replaces the de novo candidate generation for the
    FIRST iteration only (--ref_guided_mode: preprocessing_ref induces the
    initial overlaps from reference alignment, polyte.py:316-318,526-535;
    later iterations re-overlap contigs de novo either way, polyte.py:403).
    """
    assert cfg.insert_size > 0, "insert_size required"
    ns = store.readcount_single
    npair2 = 2 * (len(store) - ns)
    total_len = sum(store.unit_len(u) for u in range(store.n_units))
    avg_len = cfg.average_read_len or total_len / max(ns + npair2, 1)
    max_tip_len = cfg.max_tip_len if cfg.max_tip_len is not None else int(round(avg_len))
    mol_ec = cfg.min_overlap_len_EC or int(round(2 + 0.5 * avg_len))

    if cfg.original_SE_count >= 0:
        SE_count, PE_count = cfg.original_SE_count, cfg.original_PE_count
    else:
        SE_count, PE_count = ns, npair2
    original_readcount = SE_count + PE_count

    intseg = cfg.insert_size - 2 * avg_len
    thresholds = build_threshold_table(avg_len, intseg, cfg.stddev, cfg.hap_cov) \
        if cfg.hap_cov > 0 else {}

    single_store = concat_to_single_end(store) if preprocessing else store
    if initial_overlaps is not None:
        overlaps = initial_overlaps
    else:
        overlaps = single_end_candidates(single_store, mol_ec, cfg.sfo_err,
                                         cfg.kmer_k)

    evidence_store = original_store if original_store is not None else single_store
    loop = _AssemblyLoop(cfg, evidence_store, thresholds, SE_count, PE_count,
                         original_readcount, max_tip_len, mol_ec)
    final_store, final_sub = loop.run(
        single_store, overlaps, None,
        EC=cfg.error_correction, diploid=False,
        min_overlap_len=cfg.min_overlap_len,
        min_clique_size=cfg.min_clique_size,
        error_rate=0.0)

    result = PolyteResult(store=final_store, subreads=final_sub,
                          iterations=loop.iteration, history=loop.history)

    if cfg.diploid and final_store is not None and len(final_store) > 0:
        dip_mol = cfg.diploid_overlap_len or cfg.min_overlap_len
        dip_overlaps = single_end_candidates(final_store, dip_mol,
                                             cfg.merge_contigs, cfg.kmer_k)
        dip_store, dip_sub = loop.run(
            final_store, dip_overlaps, final_sub,
            EC=False, diploid=True,
            min_overlap_len=dip_mol, min_clique_size=2,
            error_rate=cfg.merge_contigs)
        result.diploid_store = dip_store
        result.diploid_subreads = dip_sub
        result.iterations = loop.iteration
        result.history = loop.history
    return result

"""Assembly-iteration settings.

One dataclass replaces the reference's boost::program_options ->
ProgramSettings plumbing (src/ViralQuasispecies.cpp:49-99, src/Types.h:19-67).
Defaults match the reference CLI defaults exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass
class Settings:
    # thresholds / filters
    min_clique_size: int = 4
    min_qual: float = 0.9  # min base prob for a superread; below -> 'N'
    min_overlap_perc: int = 0
    min_overlap_len: int = 150
    edge_threshold: float = 0.99
    ov_threshold: float = 0.9
    mismatch: float = 0.0  # min per-position prob in overlap (hard reject)
    merge_contigs: float = 0.0  # mismatch-rate based edge acceptance
    min_read_len: int = 0
    max_tip_len: int = 150
    keep_singletons: int = 0
    max_overlaps: int = 100000000
    max_reads: int = 100000000

    # mode switches
    first_it: bool = True
    # WAIVED alternative orientation mode (duplicate vertex per reverse
    # complement + equivalent edges, src/OverlapGraph.cpp:608-719 and
    # src/ViralQuasispecies.cpp:246-270): default-false in the reference CLI
    # and never enabled by ANY reference workflow (savage.py, polyte.py,
    # pipeline_per_stage.py all drive the resolve_orientations path) —
    # rejected at validation below rather than silently ignored.
    add_duplicates: bool = False
    resolve_orientations: bool = True
    error_correction: bool = False
    cliques: bool = False
    graph_only: bool = False
    fno: int = 2
    ignore_inclusions: bool = False
    optimize: bool = True
    no_inclusions: bool = False
    remove_multi_occ: bool = False
    remove_trans: int = 0  # 0 none / 1 transitive / 2 double / 3 triple
    remove_branches: bool = False
    remove_tips: bool = True
    store_tips_separately: bool = True
    relax_PE_edges: bool = False
    diploid: bool = False
    careful: bool = True  # careful diploid merging
    verbose: bool = False

    # branch reduction (POLYTE)
    branch_reduction: bool = False
    branch_SE_c: int = 0
    branch_PE_c: int = 0
    original_fastq: str = ""

    # bookkeeping
    original_readcount: int = 0
    output_dir: str = ""

    # rebuild-specific knobs (no reference equivalent)
    # "auto" probes the deployment once (ops/autoback.py) and picks the
    # chip path or the native host engine; "jax" device kernels | "numpy"
    # host f64 oracle | "native" C++ OpenMP engine
    backend: str = "auto"
    exact: bool = True  # f64 re-check of near-threshold device scores
    # reproduce the reference binary's output ORDER exactly (quick-cliques
    # emission order + libstdc++ unordered_map iteration order); results are
    # correct either way, but bit-identical contig parity needs this on
    reference_order: bool = True

    def __post_init__(self):
        if self.add_duplicates:
            raise ValueError(
                "add_duplicates (duplicate-vertex orientation mode) is waived: "
                "no reference workflow enables it; use resolve_orientations "
                "(the default) instead. See docs/COVERAGE.md.")

    def derive(self, **kwargs) -> "Settings":
        return replace(self, **kwargs)

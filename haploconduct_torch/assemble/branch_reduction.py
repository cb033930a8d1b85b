"""POLYTE's read-evidence branch reduction (rebuild of src/BranchReduction.cpp).

For every branch u->(v_0..v_k) (or mirrored in-branch):
1. collect the FIRST <=100 difference positions between every pair of
   branch sequences (diff_list);
2. evidence for edge i = original subreads shared between u and v_i (PE
   mates identified modulo PE_count) whose sequence agrees with v_i's
   contig at ALL covered diff positions;
3. assemble branching components by alternating in/out branches;
4. per component, intersect evidence of edges seen from both sides, strip
   evidence shared between edges (unique support only), and delete edges
   whose unique evidence is below the threshold for the component's
   variation distance (evidence_threshold_table from
   workflows/min_ev_table.py);
5. careful mode skips components neighboring already-kept components;
   diploid mode resolves "typical double branches" explicitly.

Removed edges are appended to graph.branching_edges so FNO1 reconsiders
them next iteration (BranchReduction.cpp:216-225).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core.reads import N_CODE, ReadStore, revcomp_codes
from ..graph.overlap_graph import OverlapGraph
from ..io.subreads import SubreadDict
from ..utils.config import Settings

NodePair = Tuple[int, int]

# HC_BR_TRACE=1 prints a per-branch/per-component trace in the same format
# as the instrumented reference build (tools/polyte_parity_debug.py uses it
# to pinpoint divergences down to a single branch decision)
import os

_TRACE = os.environ.get("HC_BR_TRACE") == "1"


def _dbg(msg: str) -> None:
    if _TRACE:
        print(msg, flush=True)


class BranchReduction:
    def __init__(self, graph: OverlapGraph, originals_dict: SubreadDict,
                 original_store: ReadStore, settings: Settings,
                 threshold_table: Dict[int, int]):
        self.g = graph
        self.store = graph.store
        self.originals_dict = originals_dict
        self.original_store = original_store
        self.s = settings
        self.thresholds = threshold_table
        self.SE_count = settings.branch_SE_c
        self.PE_count = settings.branch_PE_c
        self.evidence_per_edge: Dict[NodePair, List[int]] = {}
        self.false_in_branches: Set[int] = set()
        self.false_out_branches: Set[int] = set()
        self.branching_components: List[Tuple[List[NodePair], int]] = []
        # vectorized-evidence state: packed original-read matrix (cached on
        # the store across iterations) + per-node originals arrays
        self._orig_packed = original_store.pack_cached()
        self._node_originals: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._node_keys: Dict[int, np.ndarray] = {}
        self._orig_unit1 = np.asarray(original_store.unit1, dtype=np.int64)

    def _originals_arrays(self, node: int):
        """(subread_ids, index1, forward) arrays of a contig's originals,
        in dict order; cached per node for the run."""
        got = self._node_originals.get(node)
        if got is None:
            d = self._originals_of(node)
            ids = np.fromiter(d.keys(), np.int64, count=len(d))
            idx1 = np.fromiter((oi.index1 for oi in d.values()), np.int64,
                               count=len(d))
            fwd = np.fromiter((oi.forward for oi in d.values()), np.bool_,
                              count=len(d))
            got = self._node_originals[node] = (ids, idx1, fwd)
        return got

    def _originals_keys(self, node: int) -> np.ndarray:
        got = self._node_keys.get(node)
        if got is None:
            d = self._originals_of(node)
            got = self._node_keys[node] = np.sort(
                np.fromiter(d.keys(), np.int64, count=len(d)))
        return got

    # ------------------------------------------------------------- helpers
    def _contig_seq(self, node: int, oriented_by: int) -> np.ndarray:
        """Single-end contig codes, oriented by `oriented_by`'s label."""
        u1, _ = self.store.units_of(node)
        fwd = bool(self.g.vertex_orientations[oriented_by])
        return self.store.unit_codes(u1, fwd)

    def _originals_of(self, node: int):
        return self.originals_dict[int(self.store.ids[node])]

    @staticmethod
    def find_diff_pos(seq1: np.ndarray, seq2: np.ndarray, limit: int = 100) -> List[int]:
        assert len(seq1) == len(seq2)
        diffs = np.flatnonzero(seq1 != seq2)
        return diffs[:limit].tolist()

    # ------------------------------------------- diff lists (396-689)
    def build_diff_list_out(self, node1: int, neighbors: List[int]):
        g, s = self.g, self.s
        rows = g.edges
        sequences, startpos, edge_idx = [], [], []
        for node in neighbors:
            e = g.get_edge_idx(node1, node, reverse_allowed=False)
            sequences.append(self._contig_seq(node, node1))
            startpos.append(int(rows["pos1"][e]))
            edge_idx.append(e)
        diff_list: List[int] = []
        missing_inclusions: List[NodePair] = []
        missing_edges: List[dict] = []
        distance_vec: List[int] = []
        n = len(neighbors)
        for i in range(n):
            for j in range(i + 1, n):
                seq_i, seq_j = sequences[i], sequences[j]
                pos_i, pos_j = startpos[i], startpos[j]
                if pos_i < pos_j:
                    rel = pos_j - pos_i
                    if rel > len(seq_i) - s.min_overlap_len:
                        missing_inclusions.append((neighbors[i], neighbors[j]))
                        continue
                    ln = min(len(seq_i) - rel, len(seq_j))
                    diffs = self.find_diff_pos(seq_i[rel:rel + ln], seq_j[:ln])
                    start = pos_j
                else:
                    rel = pos_i - pos_j
                    if rel > len(seq_j) - s.min_overlap_len:
                        missing_inclusions.append((neighbors[j], neighbors[i]))
                        continue
                    ln = min(len(seq_j) - rel, len(seq_i))
                    diffs = self.find_diff_pos(seq_i[:ln], seq_j[rel:rel + ln])
                    start = pos_i
                diff_list.extend(p + start for p in diffs)
                if not diffs:
                    missing_edges.append(self._missing_edge(
                        neighbors[i], neighbors[j], pos_i, pos_j, rel, ln,
                        len(seq_i), len(seq_j), edge_idx[i], edge_idx[j],
                        from_out=True))
                    self.false_out_branches.add(node1)
                elif i == 0:
                    distance_vec.append(diffs[0] + start)
        dist = int(0.5 * (min(distance_vec) + max(distance_vec))) if distance_vec else 0
        diff_list = sorted(set(diff_list))
        return diff_list, dist, sequences, startpos, missing_inclusions, missing_edges

    def build_diff_list_in(self, node1: int, neighbors: List[int]):
        g, s = self.g, self.s
        rows = g.edges
        sequences, pos_vec, edge_idx = [], [], []
        node1_len = 0
        for node in neighbors:
            e = g.get_edge_idx(node, node1, reverse_allowed=False)
            sequences.append(self._contig_seq(node, node1))
            pos_vec.append(int(rows["pos1"][e]))
            edge_idx.append(e)
            if node1_len == 0:
                node1_len = self.store.read_len(int(rows["v2"][e]))
        max_pos = max(pos_vec)
        startpos = [max_pos - p for p in pos_vec]
        diff_list: List[int] = []
        missing_edges: List[dict] = []
        distance_vec: List[int] = []
        n = len(neighbors)
        for i in range(n):
            for j in range(i + 1, n):
                seq_i, seq_j = sequences[i], sequences[j]
                pos_i, pos_j = startpos[i], startpos[j]
                overlap_len = min(len(seq_i) - pos_vec[i], len(seq_j) - pos_vec[j])
                if pos_i < pos_j:
                    rel = pos_j - pos_i
                    ln = min(len(seq_i) - rel, len(seq_j))
                    diffs = self.find_diff_pos(seq_i[rel:rel + ln][::-1], seq_j[:ln][::-1])
                    start = pos_j
                else:
                    rel = pos_i - pos_j
                    ln = min(len(seq_j) - rel, len(seq_i))
                    diffs = self.find_diff_pos(seq_i[:ln][::-1], seq_j[rel:rel + ln][::-1])
                    start = pos_i
                diff_list.extend(ln - p + start for p in diffs)
                if not diffs:
                    missing_edges.append(self._missing_edge(
                        neighbors[i], neighbors[j], pos_i, pos_j, rel, ln,
                        len(seq_i), len(seq_j), edge_idx[i], edge_idx[j],
                        from_out=False))
                    self.false_in_branches.add(node1)
                elif i == 0:
                    distance_vec.append(diffs[0] + node1_len - overlap_len)
        dist = int(0.5 * (min(distance_vec) + max(distance_vec))) if distance_vec else 0
        diff_list = sorted(set(diff_list))
        return diff_list, dist, sequences, startpos, missing_edges

    def _missing_edge(self, node_i, node_j, pos_i, pos_j, rel, ln,
                      len_i, len_j, e_i, e_j, from_out: bool) -> dict:
        """Identical-overlap branch pair: emit the missing edge record
        (BranchReduction.cpp:475-514 / 629-668)."""
        rows = self.g.edges
        ori_field = "ori2" if from_out else "ori1"
        if pos_i < pos_j or (pos_i == pos_j and node_i < node_j):
            v1, v2 = node_i, node_j
            ori1 = bool(rows[ori_field][e_i])
            ori2 = bool(rows[ori_field][e_j])
        else:
            v1, v2 = node_j, node_i
            ori1 = bool(rows[ori_field][e_j])
            ori2 = bool(rows[ori_field][e_i])
        perc = int(100 * ln // min(len_i, len_j))
        return dict(v1=v1, v2=v2, score=self.s.edge_threshold, pos1=rel, pos2=0,
                    ori1=ori1, ori2=ori2, ord=b"-", perc=perc, len1=ln, len2=0)

    # ------------------------------------- evidence collection (229-394)
    def find_branching_evidence(self, node1: int, neighbors: List[int],
                                missing_edges: List[dict], outbranch: bool):
        final_branch = [node1] + list(neighbors)
        if outbranch:
            (diff_list, distance, sequences, startpos,
             missing_inclusions, new_missing) = self.build_diff_list_out(node1, neighbors)
        else:
            (diff_list, distance, sequences, startpos,
             new_missing) = self.build_diff_list_in(node1, neighbors)
            missing_inclusions = []
        missing_edges.extend(new_missing)

        evidence_per_neighbor: Dict[int, List[int]] = {}
        orc = self.s.original_readcount
        keys1 = self._originals_keys(node1)
        dp_arr = np.asarray(diff_list, dtype=np.int64)
        packed = self._orig_packed
        U = packed.n_units
        store = self.original_store
        unit1_arr = self._orig_unit1
        subreads1 = self._originals_of(node1)
        for node2, contig, start in zip(neighbors, sequences, startpos):
            # Evidence scan (BranchReduction.cpp:716-743). Two regimes:
            # small origin sets go through the scalar dict-intersection
            # loop (its per-item cost is nanoseconds and the candidate
            # intersection is usually tiny); large ones through a batched
            # (candidate-subread, diff-pos) compare matrix against the
            # packed original-read rows. The scalar semantics are
            # reproduced exactly by both (agree at ALL covered diff
            # positions, with at least one covered); measured crossover
            # ~2k originals/contig (BASELINE.md branch-reduction rows).
            d2 = self._originals_of(node2)
            if len(dp_arr) == 0:
                # empty diff list: check_read_evidence is False for every
                # candidate — skip the per-candidate read-code decodes
                evidence_per_neighbor[node2] = []
                continue
            if len(d2) < 2048:
                evidence: List[int] = []
                for subread_id, oi in d2.items():
                    in1s = subread_id in subreads1
                    if subread_id >= self.SE_count + self.PE_count:
                        mate_id = subread_id - self.PE_count
                    elif subread_id >= self.SE_count:
                        mate_id = subread_id + self.PE_count
                    else:
                        mate_id = None
                    mate_in1 = mate_id is not None and mate_id in subreads1
                    if not in1s and not mate_in1:
                        continue
                    orig_idx = store.id_to_index[subread_id]
                    u1, _ = store.units_of(orig_idx)
                    seq = store.unit_codes(u1, oi.forward)
                    ok = self.check_read_evidence(contig, start, seq,
                                                  oi.index1, diff_list)
                    if in1s and ok:
                        evidence.append(subread_id)
                    if mate_in1 and ok:
                        evidence.append(orc + min(subread_id, mate_id))
                evidence_per_neighbor[node2] = sorted(set(evidence))
                continue
            ids, idx1, fwd = self._originals_arrays(node2)
            if len(keys1) == 0:
                evidence_per_neighbor[node2] = []
                continue
            pos1 = np.searchsorted(keys1, ids)
            pos1c = np.minimum(pos1, len(keys1) - 1)
            in1 = (pos1 < len(keys1)) & (keys1[pos1c] == ids)
            mate = np.where(ids >= self.SE_count + self.PE_count,
                            ids - self.PE_count,
                            np.where(ids >= self.SE_count,
                                     ids + self.PE_count, -1))
            posm = np.searchsorted(keys1, mate)
            posmc = np.minimum(posm, len(keys1) - 1)
            mate_in1 = ((mate >= 0) & (posm < len(keys1))
                        & (keys1[posmc] == mate))
            cand = np.flatnonzero(in1 | mate_in1)
            if len(cand) == 0 or len(dp_arr) == 0:
                evidence_per_neighbor[node2] = []
                continue
            c_ids = ids[cand]
            c_idx1 = idx1[cand]
            c_fwd = fwd[cand]
            if store.ids_identity():
                orig_idx = c_ids
            else:
                sk, order = store.ids_index()
                orig_idx = order[np.searchsorted(sk, c_ids)]
            u1 = unit1_arr[orig_idx]
            rows = np.where(c_fwd, u1, u1 + U)
            rlen = packed.lens[u1].astype(np.int64)
            read_start = start + c_idx1
            # (n_cand, D) offsets into each read
            off = dp_arr[None, :] - read_start[:, None]
            in_read = (off >= 0) & (off < rlen[:, None])
            in_contig = (dp_arr >= start) & (dp_arr < start + len(contig))
            covered = in_read & in_contig[None, :]
            vals = packed.codes[rows[:, None],
                                np.clip(off, 0, packed.width - 1)]
            cv = contig[np.clip(dp_arr - start, 0, len(contig) - 1)]
            agree = vals == cv[None, :]
            ok_vec = (~(covered & ~agree).any(axis=1)) & covered.any(axis=1)
            evidence: List[int] = []
            for kk in np.flatnonzero(ok_vec):
                ci = cand[kk]
                if in1[ci]:
                    evidence.append(int(ids[ci]))
                if mate_in1[ci]:
                    evidence.append(orc + int(min(ids[ci], mate[ci])))
            evidence_per_neighbor[node2] = sorted(set(evidence))

        for pair in missing_inclusions:
            evidence_per_neighbor[pair[0]] = []
            if len(neighbors) == 2:
                final_branch = []
            else:
                final_branch = [v for v in final_branch if v != pair[0]]

        if _TRACE:
            arrow = "->" if outbranch else "<-"
            _dbg(f"BRDBG branch node={node1} out={int(outbranch)} dist={distance}"
                 f" final: {' '.join(map(str, final_branch))}"
                 f" diff: {' '.join(map(str, diff_list))}".rstrip())
            for node2 in neighbors:
                ids = " ".join(map(str, evidence_per_neighbor[node2]))
                _dbg(f"BRDBG   ev {node1}{arrow}{node2}: {ids}".rstrip())

        # store / intersect evidence per edge
        branch_rest = final_branch[1:] if final_branch else []
        k = 0
        for neighbor in neighbors:
            if k < len(branch_rest) and neighbor == branch_rest[k]:
                edge = (node1, neighbor) if outbranch else (neighbor, node1)
                cur = evidence_per_neighbor[neighbor]
                if edge in self.evidence_per_edge:
                    existing = self.evidence_per_edge[edge]
                    self.evidence_per_edge[edge] = [e for e in existing if e in cur]
                else:
                    self.evidence_per_edge[edge] = list(cur)
                k += 1
        return final_branch, distance

    @staticmethod
    def check_read_evidence(contig: np.ndarray, startpos: int, read: np.ndarray,
                            index: int, diff_list: List[int]) -> bool:
        """Read agrees with the contig at all covered diff positions
        (BranchReduction.cpp:716-743)."""
        true_evidence = False
        read_start = startpos + index
        read_end = read_start + len(read)
        contig_start = startpos
        contig_end = startpos + len(contig)
        for dp in diff_list:
            if dp < read_start or dp >= read_end:
                continue
            if dp < contig_start or dp >= contig_end:
                continue
            if read[dp - read_start] != contig[dp - contig_start]:
                return False
            true_evidence = True
        return true_evidence

    # ----------------------------------------- components (745-1007)
    def find_branching_components(self, final_in: Dict[int, Tuple[List[int], int]],
                                  final_out: Dict[int, Tuple[List[int], int]],
                                  edges_to_remove: List[NodePair]) -> None:
        g = self.g
        visited_in = {n: False for n in final_in}
        visited_out = {n: False for n in final_out}
        in_map = {n: v[0][1:] for n, v in final_in.items()}
        out_map = {n: v[0][1:] for n, v in final_out.items()}
        in_dist = {n: v[1] for n, v in final_in.items()}
        out_dist = {n: v[1] for n, v in final_out.items()}

        def extend_out(component, neighbors, state):
            dist_node = None
            for node in neighbors:
                if node not in visited_out or visited_out[node]:
                    continue
                if node in self.false_out_branches:
                    state["false"] = True
                branch = out_map[node]
                dist_node = (out_dist[node], node)
                for nb in branch:
                    component.append((node, nb))
                visited_out[node] = True
                extend_in(component, branch, state)
            if dist_node is None:
                dist_node = (0, neighbors[0])
            return dist_node

        def extend_in(component, neighbors, state):
            for node in neighbors:
                if node not in visited_in or visited_in[node]:
                    continue
                if node in self.false_in_branches:
                    state["false"] = True
                branch = in_map[node]
                for nb in branch:
                    component.append((nb, node))
                visited_in[node] = True
                extend_out(component, branch, state)

        # the reference stores branches in unordered_maps and builds
        # components in their ITERATION order (BranchReduction.cpp:784-866);
        # component order matters through careful-mode component skipping
        if self.s.reference_order:
            from ..utils.cpporder import umap_order

            in_order = umap_order(in_map.keys())
            out_order = umap_order(out_map.keys())
        else:
            in_order = list(in_map.keys())
            out_order = list(out_map.keys())

        for node in in_order:
            if visited_in[node]:
                continue
            neighbors = in_map[node]
            component = [(nb, node) for nb in neighbors]
            state = {"false": node in self.false_in_branches}
            visited_in[node] = True
            dist1 = in_dist[node]
            dist2, outnode = extend_out(component, neighbors, state)
            e = g.get_edge_idx(outnode, node, reverse_allowed=False)
            rows = g.edges
            len1 = self.store.read_len(int(rows["v1"][e]))
            len2 = self.store.read_len(int(rows["v2"][e]))
            overlap_len = int(rows["len1"][e]) + int(rows["len2"][e])
            if overlap_len < 100:
                dist1 = max(dist1, len2 - overlap_len + 100)
                dist2 = max(dist2, len1 - overlap_len + 100)
            else:
                dist1 = max(dist1, len2)
                dist2 = max(dist2, len1)
            dist = dist1 + dist2 - len1 - len2 + overlap_len
            component = sorted(set(component))
            if state["false"]:
                edges_to_remove.extend(component)
            else:
                self.branching_components.append((component, dist))

        for node in out_order:
            if visited_out[node]:
                continue
            neighbors = out_map[node]
            component = [(node, nb) for nb in neighbors]
            dist1 = out_dist[node]
            innode = neighbors[0]
            e = g.get_edge_idx(node, innode, reverse_allowed=False)
            rows = g.edges
            len1 = self.store.read_len(int(rows["v1"][e]))
            len2 = self.store.read_len(int(rows["v2"][e]))
            overlap_len = int(rows["len1"][e]) + int(rows["len2"][e])
            if overlap_len < 100:
                dist1 = max(dist1, len1 - overlap_len + 100)
                dist2 = len2 - overlap_len + 100
            else:
                dist1 = max(dist1, len1)
                dist2 = len2
            dist = dist1 + dist2 - len1 - len2 + overlap_len
            if node in self.false_out_branches:
                edges_to_remove.extend(component)
            else:
                self.branching_components.append((sorted(set(component)), dist))
            visited_out[node] = True

    # --------------------------------------- unique evidence (1009-1272)
    def count_unique_evidence(self, component: List[NodePair], min_evidence: int,
                              edges_to_remove: List[NodePair]) -> bool:
        unique: Dict[NodePair, List[int]] = {pair: [] for pair in component}
        status = []
        in_nodes = set()
        out_nodes = set()
        for pair in component:
            in_nodes.add(pair[1])
            out_nodes.add(pair[0])
            ev = self.evidence_per_edge.get(pair)
            if ev is None:
                status.append(0)
            else:
                status.append(1 if ev else 0)
        typical_double = (len(component) in (3, 4)
                          and len(in_nodes) == 2 and len(out_nodes) == 2)
        # strip shared evidence: sweep sorted lists in parallel, keep only
        # ids unique to a single edge
        work = {pair: list(self.evidence_per_edge.get(pair, [])) for pair in component}
        while status and max(status) == 1:
            current = []
            for idx, pair in enumerate(component):
                if status[idx] == 1:
                    current.append(work[pair][0])
            current.sort()
            cmin = current[0]
            unique_min = len(current) == 1 or cmin < current[1]
            for idx, pair in enumerate(component):
                if status[idx] == 1 and work[pair][0] == cmin:
                    if unique_min:
                        unique[pair].append(cmin)
                    work[pair].pop(0)
                    if not work[pair]:
                        status[idx] = 0

        if self.s.diploid and typical_double:
            return self._resolve_typical_double(component, unique, min_evidence,
                                                edges_to_remove)

        keep_component = False
        for pair, ev in unique.items():
            count = len(sorted(set(ev)))
            _dbg(f"BRDBG unique {pair[0]},{pair[1]} count={count}")
            if count < min_evidence:
                edges_to_remove.append(pair)
            else:
                keep_component = True
        return keep_component

    def _resolve_typical_double(self, component, unique, min_evidence,
                                edges_to_remove) -> bool:
        """Diploid 'typical double branch' resolution
        (BranchReduction.cpp:1098-1235)."""
        pairs = sorted(((pair, len(set(unique[pair]))) for pair in component),
                       key=lambda t: t[1])
        supported = []
        unsupported = []
        max_count, max_edge = 0, None
        for pair, count in pairs:
            if count > max_count:
                max_count, max_edge = count, pair
            (supported if count > 0 else unsupported).append(pair)
        keep_component = len(supported) > 0
        if len(supported) == 1:
            for rp in unsupported:
                if rp[0] == max_edge[0] or rp[1] == max_edge[1]:
                    edges_to_remove.append(rp)
            return keep_component
        if len(supported) == 2 and supported[0][0] != supported[1][0] \
                and supported[0][1] != supported[1][1]:
            edges_to_remove.extend(unsupported)
            return keep_component
        if len(supported) == 2:
            keep_complement = False
            if pairs[0][1] - pairs[1][1] > 0.5 * min_evidence:
                edges_to_remove.append(supported[1])
                keep_complement = True
            for rp in unsupported:
                if not keep_complement or rp[0] == max_edge[0] or rp[1] == max_edge[1]:
                    edges_to_remove.append(rp)
            return keep_component
        if len(supported) > 2:
            load1 = load2 = 0
            for i, (rp, cnt) in enumerate(pairs):
                if rp != max_edge and (rp[0] == max_edge[0] or rp[1] == max_edge[1]):
                    load2 += cnt
                else:
                    load1 += cnt
            if load1 >= load2:
                for rp in unsupported + supported:
                    if rp != max_edge and (rp[0] == max_edge[0] or rp[1] == max_edge[1]):
                        edges_to_remove.append(rp)
            else:
                for rp in unsupported + supported:
                    if rp == max_edge or (rp[0] != max_edge[0] and rp[1] != max_edge[1]):
                        edges_to_remove.append(rp)
            return keep_component
        # no supported edges at all
        for pair, ev in unique.items():
            if len(set(ev)) < min_evidence:
                edges_to_remove.append(pair)
        return keep_component

    # -------------------------------------------------------- entry point
    def run(self) -> None:
        g = self.g
        g.sort_adj_out_by_target()
        g.rebuild_adj_in()
        rows = g.edges
        out_deg = g.out_degree()
        in_deg = g.in_degree()
        branch_out = [v for v in range(g.n) if out_deg[v] > 1]
        branch_in = [v for v in range(g.n) if in_deg[v] > 1]
        _dbg("BRDBG branch_in: " + " ".join(map(str, branch_in)))
        _dbg("BRDBG branch_out: " + " ".join(map(str, branch_out)))

        missing_edges: List[dict] = []
        final_in: Dict[int, Tuple[List[int], int]] = {}
        for node in branch_in:
            neighbors = sorted(int(rows["v1"][e]) for e in g.adj_in[node])
            branch, dist = self.find_branching_evidence(node, neighbors, missing_edges, False)
            if branch:
                final_in[node] = (branch, dist)
        final_out: Dict[int, Tuple[List[int], int]] = {}
        for node in branch_out:
            neighbors = sorted(int(rows["v2"][e]) for e in g.adj_out[node])
            branch, dist = self.find_branching_evidence(node, neighbors, missing_edges, True)
            if branch:
                final_out[node] = (branch, dist)

        # missing edges get reconsidered by FNO1 next iteration
        from ..ops.verify import EDGE_DTYPE

        for me in missing_edges:
            row = np.zeros(1, dtype=EDGE_DTYPE)[0]
            for key, val in me.items():
                row[key if key != "score" else "score"] = val
            g.branching_edges.append(row)

        edges_to_remove: List[NodePair] = []
        self.find_branching_components(final_in, final_out, edges_to_remove)

        # careful mode: track neighboring components
        neighboring: List[Set[int]] = []
        if self.s.careful:
            nodes_to_components: Dict[int, Set[int]] = {}
            for idx, (component, _) in enumerate(self.branching_components):
                for a, b in component:
                    nodes_to_components.setdefault(a, set()).add(idx)
                    nodes_to_components.setdefault(b, set()).add(idx)
            for component, _ in self.branching_components:
                nb: Set[int] = set()
                for a, b in component:
                    nb |= nodes_to_components.get(a, set())
                    nb |= nodes_to_components.get(b, set())
                neighboring.append(nb)
        else:
            neighboring = [set() for _ in self.branching_components]

        components_kept: Set[int] = set()
        for idx, (component, dist) in enumerate(self.branching_components):
            skip = False
            for comp_idx in neighboring[idx]:
                if comp_idx != idx and comp_idx in components_kept:
                    edges_to_remove.extend(component)
                    skip = True
            if _TRACE:
                pairs = " ".join(f"{a},{b}" for a, b in component)
                _dbg(f"BRDBG component idx={idx} dist={dist} skip={int(skip)} pairs: {pairs}")
            if skip:
                continue
            if dist in self.thresholds:
                if self.count_unique_evidence(component, self.thresholds[dist],
                                              edges_to_remove):
                    components_kept.add(idx)
            else:
                edges_to_remove.extend(component)

        final_removals = sorted(set(edges_to_remove))
        _dbg("BRDBG edges_to_remove: "
             + " ".join(f"{a},{b}" for a, b in final_removals))
        for pair in final_removals:
            edge = g.remove_edge(pair[0], pair[1])
            g.branching_edges.append(edge)


def read_based_branch_reduction(
    graph: OverlapGraph,
    originals_dict: SubreadDict,
    original_store: Optional[ReadStore] = None,
    threshold_table: Optional[Dict[int, int]] = None,
) -> None:
    if original_store is None or threshold_table is None:
        raise ValueError(
            "branch_reduction requires the original read store and the "
            "evidence threshold table (see workflows/min_ev_table.py)")
    BranchReduction(graph, originals_dict, original_store, graph.s,
                    threshold_table).run()

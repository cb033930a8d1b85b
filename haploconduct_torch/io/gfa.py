"""Graph exports: GFA1 (for Bandage), graph.txt (clique input), digraph.txt.

Formats match the reference writers:
- graph.txt: line1 = #vertices, line2 = #edge-lines, then "i,j" per edge with
  BOTH directions written (undirected view for clique enumeration); vertices
  marked as inclusions are excluded (src/OverlapGraph.cpp:320-384).
- GFA1: header, an S line per single-end vertex, an L line per S-S edge
  (src/OverlapGraph.cpp:468-543).
- digraph.txt: "i\\tj" per directed edge (src/OverlapGraph.cpp:386-409).
"""

from __future__ import annotations

from typing import Sequence


def write_graph_txt(path: str, n_vertices: int, edges, inclusions=None) -> None:
    """edges: iterable of (i, j) directed pairs (adjacency order).

    For every retained edge (i, j) both "i,j" and "j,i" lines are written;
    an edge is skipped if the mirror (j < i) edge already exists in `edges`
    (the reference checks the graph, we expect the caller to pass each
    undirected edge once or rely on the duplicate skip below).
    """
    incl = set(inclusions) if inclusions is not None else set()
    seen = set()
    lines = []
    count = 0
    for i, j in edges:
        if i in incl or j in incl:
            continue
        key = (min(i, j), max(i, j))
        if key in seen:
            continue
        seen.add(key)
        lines.append(f"{i},{j}\n{j},{i}\n")
        count += 1
    with open(path, "w") as f:
        f.write(f"{n_vertices}\n{2 * count}\n")
        f.writelines(lines)


def write_digraph_txt(path: str, edges) -> None:
    with open(path, "w") as f:
        for i, j in edges:
            f.write(f"{i}\t{j}\n")


def write_fastg(path: str, vertex_seqs: dict, edges) -> None:
    """FASTG export (src/OverlapGraph.cpp:412-465): per single-end vertex a
    '>id:adj1,adj2,...;' header followed by its oriented sequence."""
    adj = {}
    for i, j, _olen in edges:
        adj.setdefault(i, []).append(j)
    with open(path, "w") as f:
        f.write("#FASTG:begin;\n")
        f.write('#FASTG:version=1.0:assembly_name="test";\n')
        for i in sorted(vertex_seqs):
            neighbors = [str(j) for j in adj.get(i, []) if j in vertex_seqs]
            header = f">{i}:" + ",".join(neighbors) if neighbors else f">{i}"
            f.write(header + ";\n")
            f.write(vertex_seqs[i] + "\n")
        f.write("#FASTG:end;")


def write_gfa(path: str, vertex_seqs: dict, edges) -> None:
    """vertex_seqs: {vertex_id: oriented sequence} for single-end vertices
    only; edges: iterable of (i, j, overlap_len). Only S-S edges are written,
    as in the reference."""
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        adj = {}
        for i, j, olen in edges:
            adj.setdefault(i, []).append((j, olen))
        for i in sorted(vertex_seqs):
            f.write(f"S\t{i}\t{vertex_seqs[i]}\n")
            for j, olen in adj.get(i, []):
                if j in vertex_seqs:
                    f.write(f"L\t{i}\t+\t{j}\t+\t{olen}M\n")

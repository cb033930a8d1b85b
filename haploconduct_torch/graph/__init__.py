"""Host-side overlap-graph phase.

Inherently sequential heuristics (orientation BFS, DFS cycle removal,
clique enumeration) stay on host; bulk edge transforms (dedup, transitive
reduction, tip detection) are vectorized with NumPy/SciPy sparse ops.
"""

from .overlap_graph import OverlapGraph

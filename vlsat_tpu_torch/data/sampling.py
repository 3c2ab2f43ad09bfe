"""Runtime subgraph sampling (reference ``utils/util_data.py:4-51``; a copy of
``vlsat_tpu/data/sampling.py`` plus ``build_neighbor_graph`` of
``vlsat_tpu/preprocess/gen_data.py:184``).

The reference's legacy loaders can, per __getitem__, grow a node subset by
BFS over a precomputed segment-neighbor graph (``sample_in_runtime`` +
``sample_num_nn`` / ``sample_num_seed`` / ``max_edges`` config keys,
config/mmgnet.json:79-83) and emit edges only between selected neighbors
instead of the full N*(N-1) graph.  These are the NumPy counterparts with
an explicit RandomState instead of global seeding.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set

import numpy as np


def _lookup(nns: Dict, key) -> Optional[Iterable[int]]:
    """Neighbor dicts come from JSON (str keys) or from ``build_neighbor_graph``
    (int keys); accept both."""
    if key in nns:
        return nns[key]
    return nns.get(str(key))


def bfs_neighbor_selection(
    nns: Dict,
    candidate_ids: Sequence[int],
    n_levels: int,
    n_seed: int = 1,
    rng: Optional[np.random.RandomState] = None,
) -> Set[int]:
    """``build_neighbor`` (util_data.py:25-51): pick ``n_seed`` random seed
    nodes, expand ``n_levels`` BFS levels over the neighbor graph, return
    the union of all neighbors found (restricted to ``candidate_ids``).
    Reference quirk kept: seeds themselves are included only when reached
    as someone's neighbor."""
    rng = rng or np.random.RandomState(0)
    candidates = list(candidate_ids)
    seeds = list(set(rng.choice(np.unique(candidates), n_seed).tolist()))
    cand_set = set(candidates)
    selected: Set[int] = set()
    frontier: Iterable[int] = seeds
    for _ in range(n_levels):
        found: Set[int] = set()
        for node in frontier:
            nn = _lookup(nns, node)
            if nn is None:
                raise KeyError(f"node {node} missing from neighbor graph")
            found |= set(int(x) for x in nn) & cand_set
        selected |= found
        frontier = found
    return selected


def edges_from_selection(
    node_ids: Sequence[int],
    nns: Dict,
    max_edges_per_node: int = -1,
    rng: Optional[np.random.RandomState] = None,
) -> List[List[int]]:
    """``build_edge_from_selection`` (util_data.py:4-22): one [i, j] edge
    per neighbor j of i inside the selection (no self loops); with a
    positive per-node cap, neighbors are subsampled WITH replacement
    (np.random.choice default — the reference can emit duplicate edges;
    kept, the padded pipeline tolerates duplicates)."""
    rng = rng or np.random.RandomState(0)
    sel = set(int(x) for x in node_ids)
    edges: List[List[int]] = []
    for s in node_ids:
        nn = _lookup(nns, s)
        if nn is None:
            raise KeyError(f"node {s} missing from neighbor graph")
        nn = set(int(x) for x in nn) & sel
        nn.discard(int(s))
        nn = sorted(nn)  # deterministic order for the rng subsample
        if 0 < max_edges_per_node < len(nn):
            nn = list(rng.choice(nn, max_edges_per_node))
        for t in nn:
            edges.append([int(s), int(t)])
    return edges


def subsample_edges(edges: List[List[int]], num_max_rel: int,
                    rng: Optional[np.random.RandomState] = None) -> List[List[int]]:
    """``num_max_rel`` cap (util_data.py:90-92): random choice WITH
    replacement over the edge list, as the reference does."""
    if num_max_rel <= 0 or len(edges) == 0:
        return edges
    rng = rng or np.random.RandomState(0)
    choices = rng.choice(range(len(edges)), num_max_rel).tolist()
    return [edges[t] for t in choices]


def build_neighbor_graph(points: np.ndarray, segments: np.ndarray,
                         radius: float = 0.5, sample: int = 512,
                         rng: Optional[np.random.RandomState] = None) -> Dict[int, Set[int]]:
    """Segment adjacency by point proximity (utils/util_data.py:25-51
    'build_neighbor' semantics, radius search instead of BFS layers): two
    segments are neighbors when some pair of their (up to ``sample``
    subsampled) points lies within ``radius``."""
    rng = rng or np.random.RandomState(0)
    ids = [int(i) for i in np.unique(segments) if i != 0]
    reps = {}
    for i in ids:
        pts = points[segments == i]
        if len(pts) > sample:
            pts = pts[rng.choice(len(pts), sample, replace=False)]
        reps[i] = pts
    nbrs: Dict[int, Set[int]] = {i: set() for i in ids}
    for a in range(len(ids)):
        for b in range(a + 1, len(ids)):
            pa, pb = reps[ids[a]], reps[ids[b]]
            d2 = np.square(pa[:, None, :] - pb[None, :, :]).sum(-1)
            if d2.min() <= radius * radius:
                nbrs[ids[a]].add(ids[b])
                nbrs[ids[b]].add(ids[a])
    return nbrs

"""The paper's primary contribution: Voronoi-cell 2-approx Steiner trees.

Single-device pipeline: :func:`repro_torch.core.steiner.steiner_tree`.
Distributed (``torch.distributed``) pipeline: :mod:`repro_torch.core.dist_steiner`.
Numpy oracles (Dijkstra / Mehlhorn / KMB / exact): :mod:`repro_torch.core.ref`.
"""

from repro_torch.core.graph import (
    EllGraph,
    Graph,
    ell_view_cached,
    from_edges,
    sort_by_dst,
    to_ell,
)
from repro_torch.core.steiner import (
    SteinerResult,
    finish_pipeline,
    run_pipeline,
    steiner_tree,
)
from repro_torch.core.tree import SteinerTree, tree_edge_list, tree_edge_sets
from repro_torch.core.voronoi import (
    VoronoiState,
    VoronoiStats,
    voronoi_cells,
    voronoi_cells_frontier,
)

__all__ = [
    "EllGraph",
    "Graph",
    "ell_view_cached",
    "from_edges",
    "sort_by_dst",
    "to_ell",
    "SteinerResult",
    "finish_pipeline",
    "run_pipeline",
    "steiner_tree",
    "SteinerTree",
    "tree_edge_list",
    "tree_edge_sets",
    "VoronoiState",
    "VoronoiStats",
    "voronoi_cells",
    "voronoi_cells_frontier",
]

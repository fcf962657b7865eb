"""graphcast [arXiv:2212.12794]: 16L d=512 encode-process-decode mesh GNN.

mesh_refinement=6 (icosphere, 40962 mesh nodes at the native resolution),
sum aggregator, n_vars=227 output channels. For the assigned graph shapes
the latent mesh is sized relative to the input graph (n_mesh ≈ N/4+1) and
the grid2mesh/mesh2grid connectivity arrives as input data.
"""

from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

MODEL = GNNConfig(
    name="graphcast",
    kind="graphcast",
    n_layers=16,
    d_hidden=512,
    aggregator="sum",
    mesh_refinement=6,
    n_vars=227,
)

REDUCED = GNNConfig(
    name="graphcast-reduced",
    kind="graphcast",
    n_layers=2,
    d_hidden=32,
    aggregator="sum",
    mesh_refinement=1,
    n_vars=7,
)

ARCH = ArchSpec(
    arch_id="graphcast",
    family="gnn",
    model=MODEL,
    shapes=GNN_SHAPES,
    source="arXiv:2212.12794",
    reduced=REDUCED,
)

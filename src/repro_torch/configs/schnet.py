"""schnet [arXiv:1706.08566]: 3 interactions d=64 rbf=300 cutoff=10."""

from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

MODEL = GNNConfig(
    name="schnet",
    kind="schnet",
    n_layers=3,
    d_hidden=64,
    n_interactions=3,
    rbf=300,
    cutoff=10.0,
)

REDUCED = GNNConfig(
    name="schnet-reduced",
    kind="schnet",
    n_layers=2,
    d_hidden=16,
    n_interactions=2,
    rbf=20,
    cutoff=5.0,
)

ARCH = ArchSpec(
    arch_id="schnet",
    family="gnn",
    model=MODEL,
    shapes=GNN_SHAPES,
    source="arXiv:1706.08566",
    reduced=REDUCED,
)

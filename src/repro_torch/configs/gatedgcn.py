"""gatedgcn [arXiv:2003.00982]: 16L d=70 gated-edge aggregation."""

from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

MODEL = GNNConfig(
    name="gatedgcn",
    kind="gatedgcn",
    n_layers=16,
    d_hidden=70,
    aggregator="gated",
    n_classes=64,
)

REDUCED = GNNConfig(
    name="gatedgcn-reduced",
    kind="gatedgcn",
    n_layers=3,
    d_hidden=16,
    aggregator="gated",
    n_classes=5,
)

ARCH = ArchSpec(
    arch_id="gatedgcn",
    family="gnn",
    model=MODEL,
    shapes=GNN_SHAPES,
    source="arXiv:2003.00982",
    reduced=REDUCED,
)

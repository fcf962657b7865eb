"""graphsage-reddit [arXiv:1706.02216]: 2L d=128 mean agg, fanout 25-10."""

from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES

MODEL = GNNConfig(
    name="graphsage-reddit",
    kind="sage",
    n_layers=2,
    d_hidden=128,
    aggregator="mean",
    sample_sizes=(25, 10),
    n_classes=41,
)

REDUCED = GNNConfig(
    name="graphsage-reduced",
    kind="sage",
    n_layers=2,
    d_hidden=16,
    aggregator="mean",
    sample_sizes=(3, 2),
    n_classes=5,
)

ARCH = ArchSpec(
    arch_id="graphsage-reddit",
    family="gnn",
    model=MODEL,
    shapes=GNN_SHAPES,
    source="arXiv:1706.02216",
    reduced=REDUCED,
)

"""mind [arXiv:1904.08030]: multi-interest capsule retrieval, d=64, K=4."""

from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES

MODEL = RecsysConfig(
    name="mind",
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    n_items=1 << 21,
    hist_len=50,
)

REDUCED = RecsysConfig(
    name="mind-reduced",
    embed_dim=16,
    n_interests=2,
    capsule_iters=2,
    n_items=1024,
    hist_len=8,
)

ARCH = ArchSpec(
    arch_id="mind",
    family="recsys",
    model=MODEL,
    shapes=RECSYS_SHAPES,
    source="arXiv:1904.08030",
    reduced=REDUCED,
)

"""stablelm-12b [hf:stabilityai]: dense GQA (kv=8), head_dim 160.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""

from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

MODEL = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
)

REDUCED = LMConfig(
    name="stablelm-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
)

ARCH = ArchSpec(
    arch_id="stablelm-12b",
    family="lm",
    model=MODEL,
    shapes=LM_SHAPES,
    source="hf:stabilityai/stablelm-2-12b",
    reduced=REDUCED,
)

"""starcoder2-3b [arXiv:2402.19173]: dense GQA (kv=2), RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""

from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

MODEL = LMConfig(
    name="starcoder2-3b",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
)

REDUCED = LMConfig(
    name="starcoder2-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
)

ARCH = ArchSpec(
    arch_id="starcoder2-3b",
    family="lm",
    model=MODEL,
    shapes=LM_SHAPES,
    source="arXiv:2402.19173",
    reduced=REDUCED,
)

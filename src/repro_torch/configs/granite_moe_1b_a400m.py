"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8), MoE 32 experts top-8 with expert d_ff=512.
"""

from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

MODEL = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=True,
    n_experts=32,
    top_k=8,
    n_shared=0,
    moe_d_ff=512,
    first_dense_layers=0,
    tie_embeddings=True,
)

REDUCED = LMConfig(
    name="granite-moe-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab=256,
    moe=True,
    n_experts=4,
    top_k=2,
    moe_d_ff=32,
    tie_embeddings=True,
)

ARCH = ArchSpec(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    model=MODEL,
    shapes=LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    reduced=REDUCED,
)

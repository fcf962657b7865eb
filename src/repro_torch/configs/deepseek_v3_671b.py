"""deepseek-v3-671b [arXiv:2412.19437; hf]: MLA + 256-expert MoE (top-8).

61L d_model=7168 128H MLA, dense d_ff=18432 (first 3 layers), MoE expert
d_ff=2048, 1 shared + 256 routed top-8, vocab 129280. The paper's MTP head
is a training objective add-on and is omitted (DESIGN.md §LM-notes); the
backbone is faithful. 8-bit Adam + ZeRO-3 are required for the train_4k
cell to fit a v5e pod (DESIGN.md §Memory).
"""

from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

MODEL = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab=129280,
    moe=True,
    n_experts=256,
    top_k=8,
    n_shared=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
)

REDUCED = LMConfig(
    name="deepseek-v3-reduced",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    moe=True,
    n_experts=8,
    top_k=2,
    n_shared=1,
    moe_d_ff=32,
    first_dense_layers=1,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
)

ARCH = ArchSpec(
    arch_id="deepseek-v3-671b",
    family="lm",
    model=MODEL,
    shapes=LM_SHAPES,
    source="arXiv:2412.19437",
    reduced=REDUCED,
)

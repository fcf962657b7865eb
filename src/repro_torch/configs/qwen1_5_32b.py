"""qwen1.5-32b [hf:Qwen family]: dense, QKV bias, MHA (kv=40).

64L d_model=5120 40H d_ff=27392 vocab=152064. decode_32k at batch 128
needs 5.5TB of bf16 KV — int8 KV-cache quantization (KIVI-style) brings it
to 2.75TB ≈ 10.7GB/chip on the 256-chip pod (DESIGN.md §Memory).
"""

from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES

MODEL = LMConfig(
    name="qwen1.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    kv_quant_int8=True,
)

REDUCED = LMConfig(
    name="qwen1.5-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    qkv_bias=True,
    kv_quant_int8=True,
)

ARCH = ArchSpec(
    arch_id="qwen1.5-32b",
    family="lm",
    model=MODEL,
    shapes=LM_SHAPES,
    source="hf:Qwen/Qwen1.5-32B",
    reduced=REDUCED,
)

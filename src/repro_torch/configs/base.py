"""Config schema for the assigned architectures and the paper's own runs.

A copy of ``repro.configs.base``: every architecture is a frozen dataclass
config + a tuple of :class:`ShapeSpec` cells, with the same fields, values
and parameter counts.  ``torch_dtype`` takes the place of the reference's
``jdtype``; the configs themselves are plain data and import no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _torch_dtype(name: str):
    import torch

    return getattr(torch, name)


# ----------------------------------------------------------------------------
# Shape cells
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture × input-shape) dry-run cell."""

    name: str
    kind: str  # train | prefill | decode | gnn_train | recsys_train | ...
    applicable: bool = True
    note: str = ""
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    graph_batch: int = 0
    # RecSys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
    ShapeSpec(
        name="long_500k",
        kind="decode",
        seq_len=524288,
        global_batch=1,
        applicable=False,
        note=(
            "long_500k requires sub-quadratic attention; all five assigned "
            "LM architectures are pure full-attention (MLA is still full "
            "attention over the latent cache), so this cell is skipped per "
            "the assignment rules — see DESIGN.md §Arch-applicability."
        ),
    ),
)

GNN_SHAPES = (
    ShapeSpec(
        name="full_graph_sm",
        kind="gnn_full",
        n_nodes=2708,
        n_edges=10556,
        d_feat=1433,
    ),
    ShapeSpec(
        name="minibatch_lg",
        kind="gnn_sampled",
        n_nodes=232965,
        n_edges=114615892,
        d_feat=602,
        batch_nodes=1024,
        fanout=(15, 10),
    ),
    ShapeSpec(
        name="ogb_products",
        kind="gnn_full",
        n_nodes=2449029,
        n_edges=61859140,
        d_feat=100,
    ),
    ShapeSpec(
        name="molecule",
        kind="gnn_batched",
        n_nodes=30,
        n_edges=64,
        d_feat=16,
        graph_batch=128,
    ),
)

RECSYS_SHAPES = (
    ShapeSpec(name="train_batch", kind="recsys_train", batch=65536),
    ShapeSpec(name="serve_p99", kind="recsys_serve", batch=512),
    ShapeSpec(name="serve_bulk", kind="recsys_serve", batch=262144),
    ShapeSpec(
        name="retrieval_cand", kind="recsys_retrieval", batch=1, n_candidates=1000000
    ),
)

STEINER_SHAPES = (
    # The paper's own workloads (Table III analogues, v5e-sized; §Dry-run).
    ShapeSpec(name="lvj_1k", kind="steiner", n_nodes=1 << 23, n_edges=1 << 27, batch=1024),
    ShapeSpec(name="ukw_1k", kind="steiner", n_nodes=1 << 26, n_edges=1 << 32, batch=1024),
    ShapeSpec(name="clw_10k", kind="steiner", n_nodes=1 << 28, n_edges=1 << 35, batch=10240),
)


# ----------------------------------------------------------------------------
# Model configs
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer family (dense / GQA / MLA / MoE)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False  # Qwen-style attention bias
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    # MoE (granite / deepseek)
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # serving
    kv_quant_int8: bool = False  # int8 KV cache (needed to fit qwen decode_32k)
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 for even TP sharding (standard
        Megatron-style padding; pad logits are masked in the loss)."""
        return -(-self.vocab // 256) * 256

    @property
    def torch_dtype(self):
        return _torch_dtype(self.dtype)

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank
                * self.n_heads
                * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank
                * self.n_heads
                * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd
            attn += self.n_heads * self.hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ffn = (self.n_experts + self.n_shared) * 3 * d * self.moe_d_ff + (
            d * self.n_experts
        )
        if self.moe:
            nd = self.first_dense_layers
            ffn_total = nd * dense_ffn + (L - nd) * moe_ffn
        else:
            ffn_total = L * dense_ffn
        return emb + L * attn + ffn_total

    def active_params_count(self) -> int:
        """Activated parameters per token (MoE top-k + shared)."""
        if not self.moe:
            return self.params_count()
        d, L = self.d_model, self.n_layers
        full = self.params_count()
        moe_layers = L - self.first_dense_layers
        all_experts = moe_layers * self.n_experts * 3 * d * self.moe_d_ff
        act_experts = moe_layers * self.top_k * 3 * d * self.moe_d_ff
        return full - all_experts + act_experts


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """Message-passing family (SAGE / GatedGCN / SchNet / GraphCast)."""

    name: str
    kind: str  # sage | gatedgcn | schnet | graphcast
    n_layers: int
    d_hidden: int
    aggregator: str = "mean"  # mean | sum | max | gated
    sample_sizes: Tuple[int, ...] = ()
    # schnet
    n_interactions: int = 0
    rbf: int = 0
    cutoff: float = 0.0
    # graphcast
    mesh_refinement: int = 0
    n_vars: int = 0
    n_classes: int = 64
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """MIND multi-interest retrieval config."""

    name: str
    embed_dim: int
    n_interests: int
    capsule_iters: int
    n_items: int = 1 << 21  # 2M-item catalog (synthetic)
    hist_len: int = 50
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return _torch_dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class SteinerConfig:
    """The paper's own workload config (graph scale set by the ShapeSpec)."""

    name: str
    mode: str = "bucket"
    mst_algo: str = "prim"
    local_steps: int = 1
    pair_chunks: int = 1
    fuse_gather: bool = True
    max_weight: int = 100


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One selectable ``--arch`` entry: config + its shape cells."""

    arch_id: str
    family: str  # lm | gnn | recsys | steiner
    model: object
    shapes: Tuple[ShapeSpec, ...]
    source: str
    reduced: object = None  # small config for CPU smoke tests

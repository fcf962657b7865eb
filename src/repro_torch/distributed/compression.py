"""Gradient compression: int8 all-reduce with error feedback.

The PyTorch counterpart of ``repro.distributed.compression``, bit for bit
on the CPU (``torch.round`` and ``jnp.round`` both round half to even, and
the expression order is the reference's).  ``compressed_psum`` quantizes a
gradient tree to int8 with per-block absmax scales before the all-reduce
and keeps the quantization residual locally ("error feedback", 1-bit-Adam
style [arXiv:2102.02888]) so the bias is corrected on the next step.

Wire bytes: 1 byte/grad + 4/QBLOCK scale bytes ≈ 1.03 B vs 2 (bf16) or
4 (f32).  As in the reference, the reduction itself is taken over the
dequantized f32 values: the int8 payload is what a wire format would
carry, and the quantization error is what error feedback corrects.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

QBLOCK = 256


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % QBLOCK
    flat = torch.cat([flat, flat.new_zeros((pad,))])
    blk = flat.reshape(-1, QBLOCK)
    scale = torch.clamp(blk.abs().amax(1), min=1e-12)
    q = torch.clamp(torch.round(blk / scale[:, None] * 127.0), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    # 127 as a tensor: CUDA divides by a Python scalar through its
    # reciprocal, one rounding away from the CPU's (and the reference's)
    # division
    x = (q.float() * scale[:, None] / torch.full((), 127.0, device=q.device)).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return x[:size].reshape(shape).to(dtype)


def compress_tree(grads: Any, err: Any):
    """Quantizes grads+err → (q8 tree of (q, scale) pairs, new local error
    residuals)."""

    def one(g, e):
        g32 = g.float() + e
        q, s = _quant(g32)
        deq = _dequant(q, s, g.shape, torch.float32)
        return (q, s), g32 - deq

    outs = tree_map(one, grads, err)  # a (q, scale) pair is a leaf here
    return tree_map(lambda o: o[0], outs), tree_map(lambda o: o[1], outs)


def _group(axis):
    """The process group of ``axis``: a group, a one-dim ``DeviceMesh``
    (``mesh["pod"]``), or None for the whole world."""
    if axis is None or isinstance(axis, dist.ProcessGroup):
        return axis
    return axis.get_group()


def group_mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total / n`` divided as ``jax.lax.pmean`` divides its sum: by ``n``
    as an f32 tensor on ``total``'s device (a Python divisor would make
    CUDA multiply by its reciprocal, which is not exact for n = 3, 5, 6,
    7, ...)."""
    return total / torch.full((), float(n), dtype=torch.float32, device=total.device)


def compressed_psum(grads: Any, err: Any, axis=None) -> Tuple[Any, Any]:
    """int8-compressed mean of each rank's ``grads`` over ``axis``.

    Every rank of ``axis`` calls it with its own local gradients (the
    reference's body under ``shard_map``).  Returns (mean-reduced f32
    grads, updated error feedback): each rank's quantized values,
    dequantized to f32, summed over the group with ``all_reduce`` and
    divided by its size, as ``jax.lax.pmean``."""
    group = _group(axis)
    n = dist.get_world_size(group)
    qtree, new_err = compress_tree(grads, err)

    def one(qs, g):
        q, s = qs
        deq = _dequant(q, s, g.shape, torch.float32)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return group_mean(deq, n)

    return tree_map(one, qtree, grads), new_err


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


"""Plain PyTorch version of the min-plus ELL relaxation kernels."""

from __future__ import annotations

import torch

IMAX = torch.iinfo(torch.int32).max


def minplus_torch(
    nbr: torch.Tensor, wgt: torch.Tensor, dist: torch.Tensor, lab: torch.Tensor
):
    """Row-wise lexicographic min of ``(dist[nbr] + wgt, lab[nbr], nbr)``.

    A lane whose candidate is not finite becomes ``(+inf, IMAX, IMAX)``;
    inputs are upcast to f32 before the add.  ``dist`` and ``lab`` are (N,)
    or (B, N) with a leading query-lane axis; returns (R,) or (B, R)
    f32 / i32 / i32.
    """
    cand = dist[..., nbr].to(torch.float32) + wgt.to(torch.float32)
    fin = torch.isfinite(cand)
    l = torch.where(fin, lab[..., nbr], IMAX)
    s = torch.where(fin, nbr, IMAX)
    m = cand.amin(dim=-1)
    e1 = cand == m[..., None]
    ml = torch.where(e1, l, IMAX).amin(dim=-1)
    e2 = e1 & (l == ml[..., None])
    ms = torch.where(e2, s, IMAX).amin(dim=-1)
    return m, ml, ms

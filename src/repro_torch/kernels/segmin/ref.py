"""Plain PyTorch version of the bucketed segment-min kernel."""

from __future__ import annotations

import torch

from repro_torch.core.graph import segment_min

IMAX = torch.iinfo(torch.int32).max
INF = float("inf")


def segmin_bucketed_torch(
    cand: torch.Tensor,
    ldst: torch.Tensor,
    lab: torch.Tensor,
    src: torch.Tensor,
    vb: int,
):
    """Per-bucket lexicographic segment min of ``(cand, lab, src)``.

    Mirrors ``repro.kernels.segmin.ref.segmin_bucketed_ref``: local ids are
    offset by ``bucket * vb`` to reduce all buckets in one flat pass; a
    lane whose candidate is not finite carries ``(+inf, IMAX, IMAX)``.
    ``ldst`` must lie in ``[0, vb)``.  Returns (NB, vb) f32 / i32 / i32.
    """
    NB, EB = cand.shape
    c = cand.to(torch.float32).reshape(-1)
    lanes = torch.arange(NB, dtype=torch.int64, device=cand.device)[:, None] * vb
    seg = (ldst.to(torch.int64) + lanes).reshape(-1)
    fin = torch.isfinite(c)
    lf = torch.where(fin, lab.reshape(-1), IMAX)
    sf = torch.where(fin, src.reshape(-1), IMAX)
    m = segment_min(c, seg, NB * vb, INF)
    e1 = c == m[seg]
    ml = segment_min(torch.where(e1, lf, IMAX), seg, NB * vb, IMAX)
    e2 = e1 & (lf == ml[seg])
    ms = segment_min(torch.where(e2, sf, IMAX), seg, NB * vb, IMAX)
    return m.view(NB, vb), ml.view(NB, vb), ms.view(NB, vb)

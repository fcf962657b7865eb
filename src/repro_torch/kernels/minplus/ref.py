"""Plain PyTorch versions of the min-plus ELL relaxation kernels."""

from __future__ import annotations

import torch

from repro_torch.core.graph import segment_min

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


def lex_merge(m0, l0, s0, m1, l1, s1):
    """Elementwise lexicographic min of two (dist, lab, src) triples (the
    reference's ``_lex_merge``)."""
    take1 = (m1 < m0) | ((m1 == m0) & ((l1 < l0) | ((l1 == l0) & (s1 < s0))))
    return (
        torch.where(take1, m1, m0),
        torch.where(take1, l1, l0),
        torch.where(take1, s1, s0),
    )


def _segment_lexmin(cand, lab, src, seg, nseg):
    """Per-segment lexicographic min of (B, E) triples along E; ``seg`` (E,)
    maps each column to its segment, and an empty segment gives the
    identity (+inf, IMAX, IMAX).  Returns (B, nseg) each."""
    B = cand.shape[0]
    idx = (seg + nseg * torch.arange(B, device=seg.device)[:, None]).reshape(-1)
    cand, lab, src = cand.reshape(-1), lab.reshape(-1), src.reshape(-1)
    m = segment_min(cand, idx, B * nseg, float("inf"))
    e1 = cand == m[idx]
    ml = segment_min(torch.where(e1, lab, IMAX), idx, B * nseg, IMAX)
    e2 = e1 & (lab == ml[idx])
    ms = segment_min(torch.where(e2, src, IMAX), idx, B * nseg, IMAX)
    return m.view(B, nseg), ml.view(B, nseg), ms.view(B, nseg)


def minplus_blocked_torch(layout, dist: torch.Tensor, lab: torch.Tensor):
    """The source-blocked relaxation folded over a ``BlockedLayout``.

    Slice by slice, in order, as the kernel folds them: the row minima of
    each slice's runs, lex-merged into the (B, R) accumulator with
    :func:`lex_merge`.  Equal to :func:`minplus_torch` of the ELL the layout
    was built from (lex-min is order-free); it checks the layout.
    """
    d = dist if dist.dim() == 2 else dist[None]
    lb = lab if lab.dim() == 2 else lab[None]
    B, R = d.shape[0], layout.rows
    dev = d.device
    out = (torch.full((B, R), float("inf"), dtype=torch.float32, device=dev),
           torch.full((B, R), IMAX, dtype=torch.int32, device=dev),
           torch.full((B, R), IMAX, dtype=torch.int32, device=dev))
    for run0, nruns in layout.slices:
        off = layout.run_off[run0:run0 + nruns + 1]
        a, b = int(off[0]), int(off[-1])
        nbr = layout.slot_nbr[a:b].long()
        seg = torch.repeat_interleave(torch.arange(nruns, device=dev), off.diff(),
                                      output_size=b - a)
        cand = d[:, nbr].to(torch.float32) + layout.slot_wgt[a:b].to(torch.float32)
        fin = torch.isfinite(cand)
        new = _segment_lexmin(cand, torch.where(fin, lb[:, nbr], IMAX),
                              torch.where(fin, nbr.to(torch.int32), IMAX), seg, nruns)
        code = layout.run_row[run0:run0 + nruns].long()
        rows = torch.where(code < 0, ~code, code)
        merged = lex_merge(*(x[:, rows] for x in out), *new)
        for x, y in zip(out, merged):
            x[:, rows] = y
    return out if dist.dim() == 2 else tuple(x[0] for x in out)

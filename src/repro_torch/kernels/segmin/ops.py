"""Public wrapper of the bucketed segment-min kernel.

Counterpart of ``repro.kernels.segmin.ops``: pads each bucket's edges up to
a multiple of ``edge_block`` with inert lanes (+inf candidates), then calls
:func:`~repro_torch.kernels.segmin.segmin.segmin_bucketed_call`.  No path
of the solver calls it yet, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segmin.segmin import segmin_bucketed_call


def segmin_bucketed(
    cand: torch.Tensor,
    ldst: torch.Tensor,
    lab: torch.Tensor,
    src: torch.Tensor,
    *,
    vb: int,
    edge_block: int = 512,
    interpret=None,
):
    """Lexicographic (cand, lab, src) segment min over bucketed edges.

    See :func:`segmin_bucketed_call` for the contract; EB need not be a
    multiple of ``edge_block`` here.  ``interpret`` is ignored.
    """
    if not (isinstance(edge_block, int) and edge_block >= 1):
        raise ValueError(f"edge_block must be a positive int, got {edge_block!r}")
    NB, EB = cand.shape
    pad = (-EB) % edge_block
    if pad:

        def grow(x, fill):
            tail = torch.full((NB, pad), fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=1)

        cand = grow(cand, float("inf"))
        ldst, lab, src = grow(ldst, 0), grow(lab, 0), grow(src, 0)
    return segmin_bucketed_call(cand, ldst, lab, src, vb=vb, edge_block=edge_block)

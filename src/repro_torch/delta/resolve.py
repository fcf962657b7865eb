"""Warm re-solve after deltas: affected-cell reset of a converged state.

Counterpart of ``repro.delta.resolve``.  Given a previous epoch's converged
:class:`~repro_torch.core.voronoi.VoronoiState` and the vertices touched by
edge deltas, the *affected cells* are the Voronoi cells owning at least one
changed vertex.  Resetting exactly those cells' vertices to their
initialization rows, and keeping every other entry, gives a warm start that
is sound for ``init=``:

* every pred-chain of an unaffected cell lies inside that cell, so no kept
  shortest path routes through a reset region or a changed edge (deleted,
  reweighted and added edges have both endpoints in ``changed``);
* relaxation only lowers entries lexicographically, so from this warm state
  it converges to the unique fixpoint a cold solve reaches, bit for bit.

Changed vertices that no seed reached carry the sentinel label S; the
sentinel "cell" is reset like any other when one of them changed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.voronoi import VoronoiState, init_state


def affected_cells(st: VoronoiState, changed: np.ndarray, num_seeds: int) -> np.ndarray:
    """Sorted unique cell labels (seed indices, possibly the sentinel S)
    owning at least one changed vertex, as a host int32 array."""
    ch = torch.as_tensor(np.asarray(changed, np.int64), device=st.lab.device)
    return torch.unique(st.lab[ch]).cpu().numpy()


def reset_affected(
    st: VoronoiState,
    seeds,
    changed: np.ndarray,
    num_seeds: int,
) -> Tuple[VoronoiState, np.ndarray, int]:
    """Resets every vertex of a delta-affected cell to its init row.

    Args:
      st: the previous epoch's converged state (on any device).
      seeds: (S,) seed vertex ids (stored-id space, like ``st``).
      changed: vertex ids touched by the deltas (stored-id space).
      num_seeds: S (the unreached sentinel label).

    Returns:
      ``(warm_state, cells, n_reset)``: the warm start for ``init=`` on the
      state's device, the affected cell labels, and how many vertices were
      reset (0: the cached state is already the new fixpoint).
    """
    cells = affected_cells(st, changed, num_seeds)
    if cells.size == 0:
        return st, cells, 0
    dev = st.lab.device
    reset = torch.isin(st.lab, torch.from_numpy(cells).to(dev))
    n_reset = int(reset.sum())
    # the init rows, duplicate seeds included (the lowest index owns them)
    init = init_state(st.lab.shape[0], torch.as_tensor(np.asarray(seeds, np.int64), device=dev))
    warm = VoronoiState(
        dist=torch.where(reset, init.dist, st.dist),
        lab=torch.where(reset, init.lab, st.lab),
        pred=torch.where(reset, init.pred, st.pred),
    )
    return warm, cells, n_reset


def entry_survives(lab: np.ndarray, changed: np.ndarray, num_seeds: int) -> bool:
    """True when a cached solve is still exact after these deltas: every
    changed vertex was unreached (label S) in its converged labels ``lab``
    (host array).  An edge touching only unreached vertices cannot alter
    any seed-rooted path; a changed vertex inside a real cell invalidates.
    """
    lab = np.asarray(lab)
    ch = np.asarray(changed, np.int64)
    if ch.size == 0:
        return True
    return bool((lab[ch] == int(num_seeds)).all())

"""The single source of truth for which solver knobs fix a memoized view.

The counterpart of ``repro.knobs``.  The reference classifies every
:class:`~repro_torch.solver.config.SolverConfig` field as a compile-time
static or a traced operand of its jitted executables.  The port has no
``jax.jit``: what drifts here is the key of a memo.  A prepared artifact
(an ELL view, a blocked layout, a mesh partition) is memoized by
:func:`repro_torch.core.graph.graph_cached` under a literal key tuple, and a
key that omits a knob its build reads serves a stale view for another
value of that knob.  So every field is classified exactly once:

  ``VIEW_KNOBS``   fix a memoized view or a prepared artifact: a build
                   that reads one must name it in its key.
  ``SOLVE_KNOBS``  are read per solve: naming one in a memo key splits the
                   memo for nothing.

The static analyzer's rule TS06 (:mod:`repro_torch.analysis`) checks every
``graph_cached`` call against this declaration, and
:func:`validate_config_coverage` (called when ``solver.config`` is
imported) fails on a field left unclassified.

:func:`sync_free` marks a function that must not read a tensor's value on
the host (the counterpart of ``solver_jit``): the analyzer treats it as a
region root.  It is a no-op at run time.  :func:`count_build` and
:func:`build_count` count memo misses (views built by ``graph_cached``,
kernel libraries loaded), which the runtime sanitizer
(:func:`repro_torch.analysis.sanitize.rebuild_guard`) reads.

This module imports the standard library only, so the analyzer reads it
without importing torch.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

VIEW_KNOBS = frozenset(
    {
        "backend",
        "mode",
        "pallas_frontier",
        "ell_width",
        "ell_pad_rows",
        "src_block",
        "mesh_shape",
    }
)

SOLVE_KNOBS = frozenset(
    {
        "mst_algo",
        "delta",
        "max_iters",
        "frontier_size",
        "block_rows",
        "interpret",
        "batch_size",
        "local_steps",
        "pair_chunks",
        "fuse_gather",
        "lab_i16",
        "telemetry_rounds",
        "telemetry_per_rank",
    }
)

# Parameter names that carry a SolverConfig field under another name
# (classification follows the aliased field).
KNOB_ALIASES = {
    "frontier": "pallas_frontier",  # the kernel schedules' flag
    "max_rounds": "max_iters",  # voronoi_cells_frontier's round cap
    "k": "ell_width",  # ell_view_cached's row width
}


def canonical_knob(name: str) -> str:
    """Resolves a parameter name to its SolverConfig field name."""
    return KNOB_ALIASES.get(name, name)


def classify(name: str) -> Optional[str]:
    """``"view"`` / ``"solve"`` / None (not a SolverConfig field)."""
    canon = canonical_knob(name)
    if canon in VIEW_KNOBS:
        return "view"
    if canon in SOLVE_KNOBS:
        return "solve"
    return None


def validate_config_coverage(fields: Iterable[str]) -> None:
    """Raises unless every SolverConfig field is classified exactly once
    and every classified name is a field."""
    names = set(fields)
    unclassified = names - VIEW_KNOBS - SOLVE_KNOBS
    if unclassified:
        raise TypeError(
            f"SolverConfig fields not classified in repro_torch.knobs: "
            f"{sorted(unclassified)}: add each to VIEW_KNOBS or SOLVE_KNOBS"
        )
    ghosts = (VIEW_KNOBS | SOLVE_KNOBS) - names
    if ghosts:
        raise TypeError(
            f"repro_torch.knobs classifies names that are not SolverConfig "
            f"fields: {sorted(ghosts)}: remove the stale entries"
        )
    overlap = VIEW_KNOBS & SOLVE_KNOBS
    if overlap:
        raise TypeError(f"knobs classified both view and solve: {sorted(overlap)}")
    bad = {a: f for a, f in KNOB_ALIASES.items() if f not in names}
    if bad:
        raise TypeError(f"KNOB_ALIASES name no SolverConfig field: {bad}")


def sync_free(fn: Callable = None, *, static: Sequence[str] = ()):
    """Marks ``fn`` as a region that reads no tensor's value on the host.

    A no-op: returns ``fn`` itself.  The static analyzer roots a region at
    every function so decorated; ``static`` names parameters that carry
    host values (Python ints, config objects) rather than tensors.

        @sync_free
        def step(params, opt_state, batch): ...

        @sync_free(static=("it",))
        def round(loop, it): ...
    """
    if fn is None:
        return lambda f: f
    return fn


_BUILDS: Dict[str, int] = {}


def count_build(key: str) -> None:
    """Counts one memo miss of kind ``key`` ("view": a ``graph_cached``
    build; "library": a kernel library loaded)."""
    _BUILDS[key] = _BUILDS.get(key, 0) + 1


def build_count(key: Optional[str] = None) -> int:
    """Memo misses of kind ``key`` so far in this process (every kind when
    None)."""
    if key is None:
        return sum(_BUILDS.values())
    return _BUILDS.get(key, 0)

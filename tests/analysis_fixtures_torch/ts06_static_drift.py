"""TS06 — memo-key drift at ``graph_cached`` calls.

Knob names and their view/solve classification come from
``repro_torch.knobs`` — the same source of truth ``SolverConfig``
checks its fields against when it is imported.
"""

from repro_torch.core.graph import graph_cached, to_ell
from repro_torch.kernels.minplus.ops import ell_layout


def missing_knob(g, cfg):
    # the build reads cfg.ell_width, a view knob, but the key omits it:
    # a later solve with another width would be served this view
    return graph_cached(g, ("ell",), lambda: to_ell(g, cfg.ell_width))  # expect: TS06


def stale_declaration(g, cfg):
    # the key names cfg.num_seeds, which is no SolverConfig field at all:
    # a stale key
    return graph_cached(g, ("ell", cfg.ell_width, cfg.num_seeds), lambda: to_ell(g, cfg.ell_width))  # expect: TS06


def solve_knob_in_key(g, cfg):
    # max_iters is read per solve — naming it splits the memo for nothing
    key = (cfg.ell_width, cfg.max_iters)
    return graph_cached(g, (cfg.ell_width, cfg.max_iters), lambda: to_ell(g, cfg.ell_width))  # expect: TS06


def fully_declared(ell, cfg, lanes):
    # every view knob the build reads is in the key: quiet
    return graph_cached(ell, ("blocked", cfg.src_block, lanes > 1),
                        lambda: ell_layout(ell, cfg.src_block, lanes))


def kernel_extras_are_not_knobs(g, k: int, vb: int):
    # k / vb are shape constants, not SolverConfig knobs — the rule has
    # nothing to say about them
    return graph_cached(g, (int(k), vb), lambda: to_ell(g, k))


def derived_declaration(g, cfg):
    # a named build function: its cfg reads are checked the same way
    def build():
        return to_ell(g, cfg.ell_width)

    return graph_cached(g, ("ell", cfg.ell_width), build)

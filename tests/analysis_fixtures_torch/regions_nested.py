"""Region-inference cases: hazards far from the sync-free root.

The analyzer must carry regions through project-internal calls,
``checkpoint`` bodies, nested defs, and ``local_call`` closures —
and static-param declarations must propagate along the same edges
(the torch counterpart of ``tests/analysis_fixtures/regions_nested.py``).
"""

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import local_call
from repro_torch.knobs import sync_free


def helper_called_from_jit(x, mode):
    # in a region transitively (entry -> helper); mode arrives static
    if mode == "dense":  # static at every call site in a region: quiet
        x = x * 2
    assert (x > 0).all()  # expect: TS01
    return x


def loop_body(carry):
    x, i = carry
    if x.sum() > 0:  # expect: TS02
        x = x - 1
    return x, i + 1


def loop_cond(carry):
    x, i = carry
    return i < 8


@sync_free(static=("mode",))
def entry(x, *, mode):
    x = helper_called_from_jit(x, mode)
    x, _ = checkpoint(loop_body, (x, torch.vmap(loop_cond)), use_reentrant=False)

    def nested(y):
        return float(y[0])  # expect: TS03

    return nested(x)


def make_sharded(mesh, spec):
    scale = 2.0  # closure var from host scope: static inside body

    def body(x):
        if scale > 1.0:  # host closure value: quiet
            x = x * scale
        assert (x > 0).all()  # expect: TS01
        return x

    return local_call(
        body, (mesh,), (spec,), spec
    )


def plain_helper(x, mode):
    # identical shape to helper_called_from_jit but never reachable from
    # a region root — the analyzer must leave host code alone
    if x.sum() > 0:
        x = x + 1
    assert (x > 0).all()
    return float(x[0]) if mode == "dense" else 0.0

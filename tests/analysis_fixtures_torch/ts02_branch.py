"""TS02 — Python control flow on tensors in a sync-free region (the
torch counterpart of ``tests/analysis_fixtures/ts02_branch.py``)."""

import torch

from repro_torch.knobs import sync_free


@sync_free(static=("mode",))
def branches(x, *, mode):
    if x.sum() > 0:  # expect: TS02
        x = x + 1
    if x.abs().max() > 1:  # expect: TS02
        x = x * 2
    flag = bool(x[0] > 0)  # expect: TS02
    while x.min() < 0:  # expect: TS02
        x = x + 1
    y = x if x.sum() > 0 else -x  # expect: TS02
    if mode == "dense":  # static knob: quiet
        x = x * 2
    if mode == "bucket" and x.shape[0] > 4:  # static and/static: quiet
        x = x[:4]
    return x, y, flag


@sync_free(static=("mode",))
def match_dispatch(x, *, mode):
    match x.sum():  # expect: TS02
        case 0:
            x = x - 1
        case _:
            x = x + 1
    match mode:  # static knob subject: quiet
        case "dense":
            x = x * 2
        case _:
            x = x * 3
    match mode:
        case "dense" if x.min() > 0:  # expect: TS02
            x = x / 2
        case _:
            pass
    sign = 1.0 if x.sum() > 0 else -1.0  # expect: TS02
    scale = 2.0 if mode == "dense" else 3.0  # static condition: quiet
    return x * sign * scale


@sync_free
def none_and_structure_checks(x, opt, tree):
    # `is None` is static — a tensor is never None
    if opt is not None:
        x = x + opt
    # string membership is dict *structure*, a host check
    if "bias" in tree:
        x = x + tree["bias"]
    return x


def host_branches(x, mode):
    # host function: Python branching is the normal thing to do
    if x > 0 and mode == "fast":
        return x
    return -x


@sync_free(static=("pair_chunks",))
def unrolled_static_loop(x, *, pair_chunks=2):
    # Python-level unrolling over a static knob is standard idiom
    for c in range(pair_chunks):
        if c == 0:
            x = x * 2
        x = x + torch.tensor(float(c))
    return x


@sync_free
def type_and_length_checks(x, *extra):
    # isinstance, len and the truth of *args are host checks on any tensor
    if isinstance(x, torch.Tensor) and len(x) > 1:
        x = x + 1
    return x + extra[0] if extra else x

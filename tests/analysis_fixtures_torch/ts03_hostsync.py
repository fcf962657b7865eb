"""TS03 — host reads inside sync-free regions."""
import numpy as np
import torch
from repro_torch.knobs import sync_free


@sync_free
def syncs(x):
    a = float(x[0])  # expect: TS03
    b = int(x.sum())  # expect: TS03
    c = x.item()  # expect: TS03
    d = x.tolist()  # expect: TS03
    e = np.asarray(x)  # expect: TS03
    f = np.maximum(x, 0.0)  # expect: TS03
    return a + b + c + e + f, d


@sync_free
def static_conversions_are_fine(x, y):
    # float()/int()/np on *static* operands is host bookkeeping, not a read
    n = int(x.shape[0])
    scale = float(n) / 2.0
    cap = np.float32(x.shape[0] * 4 + 64)
    return x * scale + y * cap


def host_conversions(arr):
    # host path: converting materialized results is the job
    total = float(arr[0])
    count = int(arr.shape[0])
    return np.asarray([total]), count


@sync_free
def data_dependent_shapes(x, counts):
    # ops whose output size is the data's: the host reads a count
    a = x.nonzero()  # expect: TS03
    b = torch.unique(x)  # expect: TS03
    c = x[x > 0]  # expect: TS03
    d = torch.repeat_interleave(x, counts)  # expect: TS03
    e = torch.where(x > 0)  # expect: TS03
    f = x.cpu()  # expect: TS03
    mask = torch.isfinite(x)
    g = x[mask]  # expect: TS03
    return a, b, c, d, e, f, g


@sync_free
def fixed_shapes_are_fine(x, counts, n: int):
    # the same work with shapes known ahead: quiet
    a = torch.repeat_interleave(x, counts, output_size=n)
    b = x.repeat_interleave(4)
    c = torch.where(x > 0, x, 0.0)
    d = x[: x.shape[0] // 2]
    return a, b, c, d

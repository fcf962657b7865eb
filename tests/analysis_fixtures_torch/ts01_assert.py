"""TS01 — assert on a tensor in a sync-free region (positive + negative)."""

from repro_torch.knobs import sync_free


@sync_free
def traced_asserts(x, y):
    assert (x > 0).all()  # expect: TS01
    assert x.sum() > y.sum()  # expect: TS01
    return x + y


@sync_free
def shape_asserts_are_static(x, y):
    # shape/dtype metadata is a host value on any tensor — these are the
    # load-bearing wrapper-style guards and must stay quiet
    assert x.shape[0] == y.shape[0]
    assert x.ndim == 2
    assert x.shape[0] % 8 == 0
    return x @ y


def host_asserts(x):
    # never in a region: plain asserts on host values are fine
    assert x > 0
    assert isinstance(x, int)
    return x * 2

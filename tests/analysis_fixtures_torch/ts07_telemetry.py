"""TS07 — obs/telemetry calls in sync-free regions need a static gate
(the torch counterpart of ``tests/analysis_fixtures/ts07_telemetry.py``:
``sync_free`` marks the regions that ``jax.jit`` marks there).
"""

from repro_torch import obs
from repro_torch.knobs import sync_free


@sync_free
def ungated(x):
    obs.counter("solver.rounds", 1)  # expect: TS07
    return x + 1


@sync_free(static=("telemetry_rounds",))
def gated(x, *, telemetry_rounds=0):
    # the zero-cost-when-disabled invariant: a static knob gates the
    # telemetry, so H=0 records nothing
    if telemetry_rounds > 0:
        obs.counter("solver.rounds", 1)
    return x + 1


def host_telemetry(x):
    # host-side recording is what obs is for — quiet
    obs.counter("host.calls", 1)
    return x

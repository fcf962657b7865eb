"""mst_ms.solve: mean milliseconds of the program's solve:mst span a query:
the host's launch of Prim's S - 1 steps, which never sync, so its wall time
where the tail is launch-bound."""

from perfkit.solvespans import mean_ms, spans


def read(rec):
    return mean_ms(spans(rec, "solve:mst", batch=False))

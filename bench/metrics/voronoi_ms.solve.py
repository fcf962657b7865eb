"""voronoi_ms.solve: mean milliseconds of the program's solve:voronoi span,
one a query: the Voronoi fixpoint loop, which ends at its last round's read
to the host."""

from perfkit.solvespans import mean_ms, spans


def read(rec):
    return mean_ms(spans(rec, "solve:voronoi"))

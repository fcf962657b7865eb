"""tail_ms.solve: mean milliseconds of the program's solve:tail span of a
single query (distance graph, MST and tree), which ends at the tree
marking's last read to the host."""

from perfkit.solvespans import mean_ms, spans


def read(rec):
    return mean_ms(spans(rec, "solve:tail", batch=False))

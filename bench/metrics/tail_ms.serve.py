"""tail_ms.serve: mean milliseconds of the program's solve:tail span of a
served batch, one span around the tail of every lane in turn."""

from perfkit.solvespans import mean_ms, spans


def read(rec):
    return mean_ms(spans(rec, "solve:tail", batch=True))

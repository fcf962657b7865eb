"""setup_s: process start to the first timed query (imports, the graph,
the program's set-up, the warm-up), by the host's clock."""


def read(rec):
    return rec.setup_s

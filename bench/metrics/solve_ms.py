"""solve_ms: the window's milliseconds over the queries completed in it,
one client in a closed loop, each query ending in its result on the host."""


def read(rec):
    return rec.window_s * 1e3 / rec.completed if rec.completed else None

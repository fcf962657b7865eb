"""served_qps: queries answered in the window over the window's seconds."""


def read(rec):
    return rec.completed / rec.window_s if rec.window_s > 0 else None

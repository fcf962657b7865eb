"""tail_idle.solve: % of the traced window in which the card ran nothing
while the host was inside a query's solve:tail span: the gaps between the
device's activities, intersected with the tail spans on the shared clock,
over the window's seconds."""

from perfkit.solvespans import idle_inside_ns, interval_ns, spans


def read(rec):
    tails = spans(rec, "solve:tail", batch=False)
    if rec.device is None or not tails or rec.device.window_s <= 0:
        return None
    idle = idle_inside_ns(rec.device.events, [interval_ns(e) for e in tails])
    return None if idle is None else 100.0 * idle / 1e9 / rec.device.window_s

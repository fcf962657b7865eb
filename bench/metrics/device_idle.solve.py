"""device_idle.solve: % of the traced window in which the card ran no
kernel, copy or fill (torch.profiler, device activity)."""


def read(rec):
    return rec.device.idle_share() if rec.device is not None else None

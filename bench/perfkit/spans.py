"""The program's spans (``repro_torch.obs``), recorded in a traced run."""


def mean_span_ms(rec, name: str):
    """Mean milliseconds of the spans named ``name``; None if there are none."""
    durs = [e["dur"] for e in rec.spans if e.get("ph") == "X" and e["name"] == name]
    return sum(durs) / len(durs) / 1e3 if durs else None

"""rounds.solve: mean relaxation rounds a query (the program's
SolveOutput.telemetry.iterations) over the window."""


def read(rec):
    return sum(rec.rounds) / len(rec.rounds) if rec.rounds else None

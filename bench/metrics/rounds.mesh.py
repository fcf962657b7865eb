"""rounds.mesh: mean global rounds a mesh query (the program's
SolveOutput.telemetry.iterations) over the window: each round an exchange
and ``local_steps`` relaxations, so what ``local_steps=2`` cuts."""


def read(rec):
    return sum(rec.rounds) / len(rec.rounds) if rec.rounds else None

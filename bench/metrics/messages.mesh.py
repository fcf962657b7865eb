"""messages.mesh: the program's candidate transmissions a round (its
SolveOutput.telemetry.messages, summed over every rank and local step),
summed over the window's queries and divided by their rounds summed."""


def read(rec):
    rounds = sum(rec.rounds)
    return sum(rec.messages) / rounds if rec.messages and rounds else None

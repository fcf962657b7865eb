"""host_reads.solve: mean device-to-host reads a query, the host_reads arg
the program counts at each read's site into its solve span."""

from perfkit.solvespans import spans


def read(rec):
    reads = [e["args"]["host_reads"] for e in spans(rec, "solve")
             if "host_reads" in e.get("args", {})]
    return sum(reads) / len(reads) if reads else None

"""batch_ms.serve: mean milliseconds of the program's serve:solve span, one
a batch (the span ends at the batch's fetch to the host)."""

from perfkit.spans import mean_span_ms


def read(rec):
    return mean_span_ms(rec, "serve:solve")

"""Entry points: the fault-tolerant LM training loop (``train``)."""

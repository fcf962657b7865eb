"""The benchmark of ``repro_torch``: the yardstick that every later change
is measured against.

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, one traffic mix or one metric is a file of
its own under ``bench/`` (``configs/``, ``traffic/``, ``metrics/``), found
by the name that ``BENCHMARK.json`` gives it; this package holds what they
share: the graph and traffic generators, the loops that drive the program,
the reduction of a device trace, the byte counts of the roofline and the
comparison with the plain reference (``bench/reference/``).

Nothing here imports JAX or the JAX package ``repro``.
"""

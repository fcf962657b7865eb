"""Fixture corpus for the port's jitlint analyzer (``repro_torch.analysis``).

Each ``tsNN_*.py`` module translates ``tests/analysis_fixtures/tsNN_*.py``
line for line into PyTorch's idiom (``@sync_free`` where the reference has
``@jax.jit``, ``checkpoint`` / ``local_call`` where it has
``lax.while_loop`` / ``shard_map``) and keeps the same trailing
``# expect: TSNN`` markers on the same lines; the harness
(tests/test_torch_analysis.py) asserts the finding set equals the tagged
set, so every finding fires AND everything untagged stays quiet.

These files are parsed, never imported (the analyzer is pure ``ast``).
"""

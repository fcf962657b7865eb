"""Bucketed lexicographic segment min: the Hopper kernel and its plain version."""

"""Prim's minimum spanning tree in one launch: the Hopper kernel and its wrapper."""

"""Graph containers, Voronoi state and the pipeline after the fixpoint."""

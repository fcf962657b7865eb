"""The model families: building blocks (``layers``) and the decoder-only
transformer with its train, decode and prefill steps (``transformer``);
the GNN family (``gnn``) and the MIND recommender (``recsys``)."""

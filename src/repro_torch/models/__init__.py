"""The LM family: building blocks (``layers``) and the decoder-only
transformer with its train, decode and prefill steps (``transformer``)."""

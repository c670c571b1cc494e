"""Training side of the port; so far only weights-only checkpoints."""

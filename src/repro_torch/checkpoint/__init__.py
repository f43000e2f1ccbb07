"""Checkpoints of the train state: atomic, async, keep-N."""

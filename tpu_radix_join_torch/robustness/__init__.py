"""Failure classes, retries, fault injection and checkpoints of the port."""

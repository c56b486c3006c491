"""Checkpoints and local-filesystem fault injection."""

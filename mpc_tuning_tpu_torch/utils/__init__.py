"""Checkpointing utilities."""

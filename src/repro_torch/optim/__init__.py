"""Optimizer of the port's training path (AdamW)."""

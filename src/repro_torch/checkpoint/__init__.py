"""Step-atomic checkpoints of the port's training state."""

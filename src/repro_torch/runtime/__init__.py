"""Host-level fault tolerance of the port's training loop."""

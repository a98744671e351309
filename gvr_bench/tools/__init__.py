"""Tools run on the card beside the benchmark (not by its runs)."""

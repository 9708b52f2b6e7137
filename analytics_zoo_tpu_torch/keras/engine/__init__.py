"""Layer base and model protocol."""

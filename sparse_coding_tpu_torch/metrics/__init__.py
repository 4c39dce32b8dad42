"""Dictionary metrics."""

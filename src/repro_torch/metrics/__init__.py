"""Answer-quality metrics of the port (copies of the reference's)."""

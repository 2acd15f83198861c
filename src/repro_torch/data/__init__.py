"""Data sources for the port: the synthetic TIMIT-shaped speech stream."""

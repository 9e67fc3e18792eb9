"""Data of the port: in-memory synthetic frames."""

"""Host-side utilities of the port: resolution algebra, YAML reading."""

"""Host-side utilities of the port: resolution algebra, YAML, PNG, NDDS discovery."""

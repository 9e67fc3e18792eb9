"""Data of the port: synthetic frames, NDDS datasets on disk and their loaders."""

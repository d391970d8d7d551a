"""Policy export and the numpy readers of the exported files."""

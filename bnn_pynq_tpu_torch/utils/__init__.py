"""Framework-neutral utilities."""

"""Network configurations, parameter conversion and forward passes."""

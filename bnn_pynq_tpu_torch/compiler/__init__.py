"""Artifact loading (numpy only)."""

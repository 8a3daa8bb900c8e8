"""Inference engine and continuous-batching server."""

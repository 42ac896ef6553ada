"""Explainability of the port."""

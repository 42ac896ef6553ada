"""Checkpoints and profiling of the port."""

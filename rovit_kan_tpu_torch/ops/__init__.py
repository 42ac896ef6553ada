"""Tensor functions and kernel wrappers of the port."""

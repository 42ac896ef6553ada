"""Losses, optimizer and train step of the port."""

"""Pretext-task samplers of the port."""

"""Benchmark entry points of the port."""

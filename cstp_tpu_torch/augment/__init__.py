"""Clip augmentation of the port: parameters, pixel ops and pipelines."""

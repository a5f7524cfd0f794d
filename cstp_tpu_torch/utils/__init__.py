"""Utilities of the port: TensorBoard events, preemption, profiling."""

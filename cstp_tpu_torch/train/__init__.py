"""Pretrain step and optimizer of the port."""

"""Checkpoints of the port (torch.save)."""

"""BYOL engine of the port: towers, pretext heads, losses, EMA."""

"""CSTP pretext constants: the port's own copy of the JAX package's
``pretext/sampling.py`` constant that the box sampler uses."""

from __future__ import annotations

from typing import Tuple

OVERLAP_SPA_RATE: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.4, 0.2)

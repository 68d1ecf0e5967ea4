"""Hand-written Hopper kernels of the port and their launch counts.

Each kernel's wrapper adds one to ``LAUNCHES[name]`` where it launches the
kernel on the card, and nowhere else (a CPU tensor takes the plain PyTorch
version and counts nothing). A run that must show it went through the
kernels calls ``reset_launches()`` before and reads ``LAUNCHES`` after.
"""
from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {"attention": 0, "found_cell": 0, "node_mixed": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0

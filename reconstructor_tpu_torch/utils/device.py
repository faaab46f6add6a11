"""Device selection shared by the entry points.

Every entry point runs on ``cuda`` unless its caller asks for another
device (the tests pass ``device="cpu"``). There is no silent fallback: a
missing card surfaces as torch's own error at the first allocation.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; anything else is taken as given."""
    return torch.device("cuda" if device is None else device)


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on ``device`` (torch draws on the device the
    tensor lives on, so a CUDA draw needs a CUDA generator)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


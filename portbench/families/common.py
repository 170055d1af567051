"""Weight drawing shared by the families: a few large in-place normal draws
on the device from one ``torch.Generator``."""

from __future__ import annotations

import math
from typing import Dict

import torch

# one normal_ call per at most this many elements (the sampling kernels
# index in 32 bits)
_CALL_ELEMENTS = 2 ** 30


def fill_normal(t: torch.Tensor, mean: float, std: float,
                gen: torch.Generator) -> torch.Tensor:
    """``t`` drawn N(mean, std) in place, in slices of the first axis of
    at most ``_CALL_ELEMENTS`` elements."""
    rows = max(1, _CALL_ELEMENTS // max(1, t[0].numel() if t.dim() else 1))
    flat = t if t.dim() else t.view(1)
    for i in range(0, flat.shape[0], rows):
        flat[i:i + rows].normal_(mean, std, generator=gen)
    return t


def draw_leaves(shapes: Dict[str, tuple], seed: int, device,
                into: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``shapes``: name -> (shape, dtype, kind, fan_in) with kind ``w``
    (N(0, 1/fan_in)) or ``norm`` (N(1, 0.1)); drawn in name order from one
    generator seeded with ``seed``, into ``into``'s tensors when given."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    out = {}
    for name in sorted(shapes):
        shape, dtype, kind, fan_in = shapes[name]
        t = into[name] if into is not None else torch.empty(
            shape, dtype=dtype, device=device)
        if kind == "w":
            fill_normal(t, 0.0, 1.0 / math.sqrt(fan_in), gen)
        else:
            fill_normal(t, 1.0, 0.1, gen)
        out[name] = t
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """``layers.<leaf>`` names into the port's nested layout."""
    params: Dict[str, object] = {"layers": {}}
    for name, t in flat.items():
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def flatten(params) -> Dict[str, torch.Tensor]:
    flat = {f"layers.{k}": v for k, v in params["layers"].items()}
    flat.update({k: v for k, v in params.items() if k != "layers"})
    return flat

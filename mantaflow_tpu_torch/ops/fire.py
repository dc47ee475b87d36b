"""Fire / combustion model.

Port of the JAX package's ``ops/fire.py`` (``source/plugin/fire.cpp``:
KnProcessBurn :22-65 / processBurn :66, KnUpdateFlame :78 / updateFlame
:87).
"""

from __future__ import annotations

import torch

from ..core.domain import Domain
from ..core.masks import interior_mask

VECTOR_EPSILON = 1e-6


def process_burn(fuel, density, react, dt, dom: Domain, red=None, green=None,
                 blue=None, heat=None, burning_rate: float = 0.75,
                 flame_smoke: float = 1.0, ignition_temp: float = 1.25,
                 max_temp: float = 1.75,
                 flame_smoke_color=(0.7, 0.7, 0.7)):
    """One combustion update; returns
    (fuel, density, react, red, green, blue, heat)."""
    inter = interior_mask(dom, 1, fuel.device)
    orig_fuel = fuel
    orig_smoke = density

    new_fuel = torch.clamp(fuel - burning_rate * dt, min=0.0)
    have_fuel = orig_fuel > VECTOR_EPSILON
    new_react = torch.where(
        have_fuel, react * new_fuel / torch.clamp(orig_fuel, min=1e-30), 0.0)
    flame = torch.where(have_fuel, torch.sqrt(torch.clamp(new_react,
                                                          min=0.0)), 0.0)

    smoke_emit = torch.where(orig_fuel < 1.0, (1.0 - orig_fuel) * 0.5, 0.0)
    smoke_emit = (smoke_emit + 0.5) * (orig_fuel - new_fuel) * 0.1 \
        * flame_smoke
    new_density = torch.clamp(density + smoke_emit, 0.0, 1.0)

    outs = {}
    if heat is not None:
        new_heat = torch.where(
            flame > 0, (1.0 - flame) * ignition_temp + flame * max_temp, heat)
        outs["heat"] = torch.where(inter, new_heat, heat)
    emit = smoke_emit > VECTOR_EPSILON
    factor = new_density / torch.clamp(orig_smoke + smoke_emit, min=1e-30)
    for name, chan, col in (("red", red, flame_smoke_color[0]),
                            ("green", green, flame_smoke_color[1]),
                            ("blue", blue, flame_smoke_color[2])):
        if chan is not None:
            mixed = (chan + col * smoke_emit) * factor
            outs[name] = torch.where(inter & emit, mixed, chan)

    return (torch.where(inter, new_fuel, fuel),
            torch.where(inter, new_density, density),
            torch.where(inter, new_react, react),
            outs.get("red"), outs.get("green"), outs.get("blue"),
            outs.get("heat"))


def update_flame(react, flame, dom: Domain):
    """updateFlame: flame = sqrt(react) in the interior."""
    new = torch.where(react > 0.0, torch.sqrt(torch.clamp(react, min=0.0)),
                      0.0)
    return torch.where(interior_mask(dom, 1, react.device), new, flame)

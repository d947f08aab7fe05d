"""The one scene generator: a cell's configuration and traffic files -> a
seeded FluidSimulation, built through the public API of whichever package
is given (the port under test, or the plain reference, which has the same
API).

A configuration file (configs/<name>.json) holds the scene as it is run:
"resolution" (cells per axis; dx = 1 / resolution unless "dx" is given),
"boundary" (meshes added to the default domain box, each {"kind", ...,
"inverted"}), "liquid" (meshes filled with jittered particles), "gravity",
"frame_dt", "viscosity", "sim_config" (SimConfig fields), the replayed
segment's length "segment_frames", the frames of a segment the output
check samples, "check_frames", and the output check's "limits". A traffic
file (traffic/<name>.json) holds keys of the same names; each overrides the
configuration's, and "sim_config" and "limits" merge key by key.

Mesh kinds: "box" (lo, hi), and the primitives "sphere" (center, radius,
subdivisions), "cube" (center, size), "rod" (center, radius, length, axis,
segments), "sheet" and "cone" with their primitives' arguments.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_MERGED = ("sim_config", "limits")


def load_spec(config: str, traffic: str, root: Path = HERE) -> dict:
    """The merged scene description of configuration `config` under
    traffic `traffic`, read from root/configs and root/traffic."""
    spec = json.loads((root / "configs" / f"{config}.json").read_text())
    mix = json.loads((root / "traffic" / f"{traffic}.json").read_text())
    for key, value in mix.items():
        if key in _MERGED:
            spec[key] = {**spec.get(key, {}), **value}
        else:
            spec[key] = value
    return spec


def _mesh(pkg, item: dict):
    args = {k: v for k, v in item.items() if k not in ("kind", "inverted")}
    if item["kind"] == "box":
        return pkg.box_mesh(tuple(args["lo"]), tuple(args["hi"]))
    return getattr(pkg.primitives, item["kind"])(**args)


def build(pkg, spec: dict, seed: int, device, sim_overrides=None):
    """A FluidSimulation of `pkg` (a namespace with FluidSimulation,
    box_mesh, primitives) holding the scene of `spec`, its particle jitter
    drawn from `seed`."""
    res = int(spec["resolution"])
    sim = pkg.FluidSimulation(device)
    sim.initialize(res, res, res, float(spec.get("dx", 1.0 / res)),
                   **{**spec.get("sim_config", {}), **(sim_overrides or {})})
    for item in spec.get("boundary", []):
        sim.add_boundary(_mesh(pkg, item), bool(item.get("inverted", False)))
    # the jitter generator: FluidSimulation seeds its torch.Generator from
    # this numpy generator's first draw in each add_liquid
    sim._rng = np.random.default_rng(int(seed) % (1 << 64))
    for item in spec["liquid"]:
        sim.add_liquid(_mesh(pkg, item))
    sim.set_viscosity(float(spec["viscosity"]))
    sim.set_gravity(*map(float, spec["gravity"]))
    return sim


def program():
    """The port's public API as build() takes it."""
    from types import SimpleNamespace

    from flipviscosity3d_torch import FluidSimulation
    from flipviscosity3d_torch.io import primitives
    from flipviscosity3d_torch.io.trianglemesh import box_mesh
    return SimpleNamespace(FluidSimulation=FluidSimulation, box_mesh=box_mesh,
                           primitives=primitives)


def reference():
    """The plain reference's copy of the same API."""
    from types import SimpleNamespace

    from .reference.core.sim import FluidSimulation
    from .reference.io import primitives
    from .reference.io.trianglemesh import box_mesh
    return SimpleNamespace(FluidSimulation=FluidSimulation, box_mesh=box_mesh,
                           primitives=primitives)

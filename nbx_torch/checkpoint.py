"""Checkpoint and resume (port of `save_state` / `load_state` of
`nbx/checkpoint.py`).

The format is the JAX package's: one .npz holding the state's fields as
`state.<field>`, the config's as `cfg.<field>` (the materials table as
`cfg.materials.density`, `.color1`, `.color2`) and `format_version`. The
JAX package's `state.key` becomes `state.generator`: the torch.Generator's
state (`get_state()`, uint8), with `state.generator_device` naming the
device type it belongs to, so a resumed run draws the same fracture
uniforms and reproduces the original bit for bit.

`load_state` also reads a file the JAX package wrote: every array but
`state.key`, which torch cannot continue; the resumed state's generator is
then seeded with `seed`, so its fracture draws are fresh ones.

The orbax and sharded checkpoints of the JAX package are not ported here:
they belong to the multi-host path (ROADMAP item 10c), with a file a rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nbx_torch.config import CUDA, Materials, SimConfig
from nbx_torch.convert import STATE_FIELDS
from nbx_torch.state import SimState, make_generator

FORMAT_VERSION = 1


def save_state(path: str, state: SimState, cfg: SimConfig | None = None) -> None:
    """Snapshot a SimState (and optionally its config) to .npz."""
    arrays = {f"state.{name}": getattr(state, name).cpu().numpy() for name in STATE_FIELDS}
    if state.contact is not None:
        arrays["state.contact"] = state.contact.cpu().numpy()
    arrays["state.generator"] = state.generator.get_state().numpy()
    arrays["state.generator_device"] = np.str_(state.generator.device.type)
    arrays["format_version"] = np.int32(FORMAT_VERSION)
    if cfg is not None:
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, Materials):
                for name in ("density", "color1", "color2"):
                    arrays[f"cfg.materials.{name}"] = getattr(v, name).cpu().numpy()
            else:
                arrays[f"cfg.{f.name}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def _generator(z, device, seed: int) -> torch.Generator:
    """The saved generator on `device`, or, for a file without one (the JAX
    package's), a new one seeded with `seed`."""
    gen = make_generator(device, seed)
    if "state.generator" not in z:
        return gen
    saved = str(z["state.generator_device"])
    if saved != gen.device.type:
        raise ValueError(f"the checkpoint's generator belongs to a {saved} device, not {gen.device.type}: "
                         f"load it onto a {saved} device")
    gen.set_state(torch.from_numpy(np.array(z["state.generator"])))
    return gen


def load_state(path: str, device=CUDA, seed: int = 0) -> tuple[SimState, SimConfig | None]:
    """Restore (state, cfg or None) onto `device` (the card unless the caller
    asks for the CPU). A file of this package resumes bit for bit, its
    generator included; a file of the JAX package loads every array but its
    PRNG key, and the generator is seeded with `seed`. A file of another
    format version raises ValueError."""
    z = np.load(path)
    version = int(z["format_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {version} != {FORMAT_VERSION}")
    kw = {name: torch.as_tensor(np.array(z[f"state.{name}"]), dtype=dtype).to(device)
          for name, dtype in STATE_FIELDS.items()}
    contact = None
    if "state.contact" in z:
        contact = torch.as_tensor(np.array(z["state.contact"]), dtype=torch.float32).to(device)
    state = SimState(**kw, generator=_generator(z, device, seed), contact=contact)

    cfg = None
    if "cfg.G" in z:
        ckw = {}
        for f in dataclasses.fields(SimConfig):
            if f.name == "materials":
                ckw["materials"] = Materials(*(
                    torch.as_tensor(np.array(z[f"cfg.materials.{name}"]), dtype=torch.float32)
                    for name in ("density", "color1", "color2")))
            elif f"cfg.{f.name}" in z:
                ckw[f.name] = type(f.default)(z[f"cfg.{f.name}"].item())
        cfg = SimConfig(**ckw).to(device)
    return state, cfg

"""Carry the JAX package's states, grids and tables into the port and back.

The reference objects are read by duck typing with ``np.asarray`` on every
leaf, so this module imports no JAX: a test hands it a reference ``State``,
``GridSpec``, ``GridMeta`` or force-table dict and gets the port's object
on a chosen device, or turns a port State back into numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.box import Box
from .core.state import State
from .ops.dense import GridMeta, GridSpec

__all__ = [
    "state_from_reference",
    "state_to_numpy",
    "grid_spec_from_reference",
    "grid_meta_from_reference",
    "pair_tables_from_reference",
    "aniso_tables_from_reference",
    "bond_tables_from_reference",
    "external_tables_from_reference",
    "mpcd_from_reference",
]

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State) if f.name != "box")


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(a)), device=device)


def state_from_reference(ref_state, device) -> State:
    """A reference State (tag or slot order) as a port State on ``device``."""
    box = Box(
        L=np.asarray(ref_state.box.L, dtype=np.float32),
        tilt=np.asarray(ref_state.box.tilt, dtype=np.float32),
    )
    return State(box=box, **{k: _tensor(getattr(ref_state, k), device) for k in _STATE_FIELDS})


def state_to_numpy(state) -> dict:
    """Every per-particle field of a port or reference State, as numpy."""

    def host(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    out = {k: host(getattr(state, k)) for k in _STATE_FIELDS}
    out["box_L"] = np.asarray(state.box.L, dtype=np.float32)
    out["box_tilt"] = np.asarray(state.box.tilt, dtype=np.float32)
    return out


def grid_spec_from_reference(ref_spec) -> GridSpec:
    """The reference's GridSpec (its TPU subtile height dropped)."""
    return GridSpec(
        dims=tuple(int(d) for d in ref_spec.dims),
        cap=int(ref_spec.cap),
        r_cut=float(ref_spec.r_cut),
        buffer=float(ref_spec.buffer),
    )


def grid_meta_from_reference(ref_meta, device) -> GridMeta:
    return GridMeta(
        ref_position=_tensor(ref_meta.ref_position, device),
        slot_of=_tensor(ref_meta.slot_of, device),
        overflow=_tensor(ref_meta.overflow, device),
        n_builds=_tensor(ref_meta.n_builds, device),
        max_occ=_tensor(ref_meta.max_occ, device),
    )


def pair_tables_from_reference(ref_tbl: dict, device) -> dict:
    """A reference pair force's tables (``{"params", "r_cut", "r_on"}``) as
    the port's device tables; DPDGeneralWeight's tables take the same form
    (its ``params`` are A, gamma and s)."""
    return {
        "params": {k: _tensor(np.asarray(v, np.float32), device)
                   for k, v in ref_tbl["params"].items()},
        "r_cut": _tensor(np.asarray(ref_tbl["r_cut"], np.float32), device),
        "r_on": _tensor(np.asarray(ref_tbl["r_on"], np.float32), device),
    }


def aniso_tables_from_reference(ref_tbl: dict, device) -> dict:
    """A reference anisotropic force's tables (``{"params", "r_cut"}``; it
    has no ``r_on``) as the port's device tables."""
    return {
        "params": {k: _tensor(np.asarray(v, np.float32), device)
                   for k, v in ref_tbl["params"].items()},
        "r_cut": _tensor(np.asarray(ref_tbl["r_cut"], np.float32), device),
    }


def bond_tables_from_reference(ref_tbl: dict, ref_state, device) -> dict:
    """A reference bond force's tables (``{"params"}``, one value per bond
    type) as the port's device tables: each parameter gathered per bond by
    the state's bond types, and the bond table itself."""
    typeid = np.asarray(ref_state.bond_typeid)
    return {
        "params": {k: _tensor(np.asarray(v, np.float32)[typeid], device)
                   for k, v in ref_tbl["params"].items()},
        "group": _tensor(ref_state.bond_group, device),
    }


def external_tables_from_reference(ref_tbl: dict, device) -> dict:
    """A reference barrier's (``{"params"}``) or wall's (``{"params",
    "r_cut", "r_extrap"}``) tables as the port's device tables; a wall's
    host decision to extrapolate is made from its ``r_extrap``."""
    out = {"params": {k: _tensor(np.asarray(v, np.float32), device)
                      for k, v in ref_tbl["params"].items()}}
    if "r_extrap" in ref_tbl:
        r_extrap = np.asarray(ref_tbl["r_extrap"], np.float32)
        out["r_cut"] = _tensor(np.asarray(ref_tbl["r_cut"], np.float32), device)
        out["r_extrap"] = _tensor(r_extrap, device)
        out["extrap"] = bool(np.any(r_extrap > 0))
    return out


def mpcd_from_reference(ref_mpcd: dict | None, device) -> dict | None:
    """A reference simulation's MPCD stream (``sim._mpcd``) as the port's:
    the arrays as tensors on ``device``, mass and types as they are, and
    the SRD anchor ``(position, velocity, t_a)``, if it has one, with its
    time as a host int."""
    if ref_mpcd is None:
        return None
    out = {
        "position": _tensor(ref_mpcd["position"], device),
        "velocity": _tensor(ref_mpcd["velocity"], device),
        "typeid": _tensor(ref_mpcd["typeid"], device),
        "mass": float(ref_mpcd["mass"]),
        "types": list(ref_mpcd["types"]),
    }
    anchor = ref_mpcd.get("_srd_anchor")
    if anchor is not None:
        out["_srd_anchor"] = (_tensor(anchor[0], device), _tensor(anchor[1], device),
                              int(np.asarray(anchor[2])))
    return out

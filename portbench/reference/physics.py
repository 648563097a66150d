"""The plain reference's physics: forces, the flow and the evaporator's pick.

Written from the azplugins documentation's equations, independent of the
program: a cell list of its own over the wrapped positions, every pair
inside its cutoff from both sides (no Newton's third law, no buffer), in
the dtype asked for (float64 for the reference; bfloat16 for the
control). A model is plain data (:func:`model_of` in each configuration's
builder): the types, a pair potential with per-type-pair parameters, an
optional spherical harmonic barrier, plane walls, the Langevin method with
an optional parabolic flow, and an optional evaporator.
"""

from __future__ import annotations

import itertools
import math

import torch

from . import threefry


def wrap(x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Positions folded into [-L/2, L/2)."""
    return x - L * torch.floor(x / L + 0.5)


def min_image(d: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    return d - L * torch.round(d / L)


def pair_table(model: dict, dtype, device) -> dict:
    """Per-type-pair coefficients ``[T * T]`` of the pair potential."""
    pair = model["pair"]
    T = len(model["types"])
    names = ("lj1", "lj2", "lam", "rwcasq", "wca_shift", "rcsq")
    tab = {n: torch.zeros(T * T, dtype=torch.float64) for n in names}
    for (a, b), p in pair["params"].items():
        eps, sigma, lam = p["epsilon"], p["sigma"], p["attraction_scale_factor"]
        vals = {"lj1": 4.0 * eps * sigma**12, "lj2": 4.0 * eps * sigma**6, "lam": lam,
                "rwcasq": 2.0 ** (1.0 / 3.0) * sigma**2, "wca_shift": eps * (1.0 - lam),
                "rcsq": pair["r_cut"] ** 2}
        for i, j in ((a, b), (b, a)):
            for n in names:
                tab[n][i * T + j] = vals[n]
    return {n: v.to(device=device, dtype=dtype) for n, v in tab.items()}


def perturbed_lj(r2, p):
    """PerturbedLennardJones (azplugins): the WCA core, the attractive tail
    scaled by lambda; mode none. Returns (energy, force / r)."""
    r2inv = 1.0 / r2
    r6inv = r2inv * r2inv * r2inv
    f = r2inv * r6inv * (12.0 * p["lj1"] * r6inv - 6.0 * p["lj2"])
    e = r6inv * (p["lj1"] * r6inv - p["lj2"])
    core = r2 < p["rwcasq"]
    e = torch.where(core, e + p["wca_shift"], e * p["lam"])
    f = torch.where(core, f, f * p["lam"])
    on = p["lj1"] != 0
    return torch.where(on, e, 0.0), torch.where(on, f, 0.0)


class CellList:
    """Particles binned into cells of at least the cutoff on each side, for
    pairs from the 27 neighbouring cells; None where an axis holds fewer
    than three cells (every pair is then tested)."""

    def __init__(self, xw: torch.Tensor, L: torch.Tensor, r_cut: float):
        n = torch.clamp(torch.floor(L / r_cut), min=1).to(torch.int64)
        self.ok = bool((n >= 3).all())
        if not self.ok:
            return
        self.n = n
        c = torch.clamp(torch.floor((xw / L + 0.5) * n).to(torch.int64), min=0)
        c = torch.minimum(c, n - 1)
        cid = (c[:, 0] * n[1] + c[:, 1]) * n[2] + c[:, 2]
        C = int(n.prod())
        order = torch.argsort(cid, stable=True)
        counts = torch.bincount(cid, minlength=C)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(xw.shape[0], device=xw.device) - start[cid[order]]
        self.cap = int(counts.max())
        self.table = torch.full((C, self.cap), -1, dtype=torch.int64, device=xw.device)
        self.table[cid[order], rank] = order
        ids = torch.arange(C, device=xw.device)
        cc = torch.stack([ids // (n[1] * n[2]), (ids // n[2]) % n[1], ids % n[2]], dim=-1)
        offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)), device=xw.device)
        nb = (cc[:, None, :] + offs[None]) % n
        self.neighbours = (nb[..., 0] * n[1] + nb[..., 1]) * n[2] + nb[..., 2]  # [C, 27]


# a pair whose squared distance lies within this share of the squared cutoff
# is inside the cutoff or not by rounding alone: float32 rounds r^2 near the
# cutoff by a few parts in 1e7, and mode "none" cuts the force off there
CUTOFF_BAND = 1e-5


def pair_forces(x: torch.Tensor, types: torch.Tensor, L: torch.Tensor, model: dict,
                dtype=torch.float64, block_pairs: int = 2**24):
    """(force [N, 3], energy [N], unordered pairs inside the cutoff, the
    cutoff's allowance [N]) of the pair potential at positions ``x``
    (float64, any image), in ``dtype``. The allowance of a particle is the
    summed |force| of its pairs within ``CUTOFF_BAND`` of the cutoff, on
    either side: a program in float32 may count each of them or not."""
    dev = x.device
    N = x.shape[0]
    T = len(model["types"])
    r_cut = model["pair"]["r_cut"]
    tab = pair_table(model, dtype, dev)
    xw = wrap(x, L)
    Ld = L.to(dtype)
    xd = xw.to(dtype)
    force = torch.zeros((N, 3), dtype=dtype, device=dev)
    energy = torch.zeros((N,), dtype=dtype, device=dev)
    allowance = torch.zeros((N,), dtype=torch.float64, device=dev)
    pairs = 0
    cells = CellList(xw, L, r_cut)

    def evaluate(i_idx, j_idx):
        """Rows ``i_idx`` [B, I] against candidates ``j_idx`` [B, J], -1 padded."""
        nonlocal pairs
        iv, jv = i_idx >= 0, j_idx >= 0
        i0, j0 = i_idx.clamp(min=0), j_idx.clamp(min=0)
        d = min_image(xd[i0][:, :, None, :] - xd[j0][:, None, :, :], Ld)
        r2 = (d * d).sum(-1)
        tp = types[i0][:, :, None] * T + types[j0][:, None, :]
        p = {k: v[tp] for k, v in tab.items()}
        real = iv[:, :, None] & jv[:, None, :] & (i_idx[:, :, None] != j_idx[:, None, :])
        inside = real & (r2 < p["rcsq"])
        band = real & ((r2 - p["rcsq"]).abs() <= CUTOFF_BAND * p["rcsq"])
        e, fr = perturbed_lj(torch.where(inside | band, r2, 1.0), p)
        edge = torch.where(band, fr.abs().to(torch.float64) * torch.sqrt(r2.to(torch.float64)), 0.0)
        fr = torch.where(inside, fr, 0.0)
        e = torch.where(inside, e, 0.0)
        f = (fr[..., None] * d).sum(2)
        rows = i_idx[iv]
        force.index_add_(0, rows, f[iv])
        energy.index_add_(0, rows, 0.5 * e.sum(2)[iv])
        allowance.index_add_(0, rows, edge.sum(2)[iv])
        pairs += int(inside.sum())

    if cells.ok:
        C = cells.table.shape[0]
        per_cell = max(1, cells.cap * 27 * cells.cap)
        step = max(1, block_pairs // per_cell)
        for c0 in range(0, C, step):
            cs = torch.arange(c0, min(C, c0 + step), device=dev)
            own = cells.table[cs]
            cand = cells.table[cells.neighbours[cs]].reshape(len(cs), -1)
            evaluate(own, cand)
    else:
        everyone = torch.arange(N, device=dev)
        step = max(1, block_pairs // max(N, 1))
        for r0 in range(0, N, step):
            rows = everyone[r0:r0 + step]
            evaluate(rows[None], everyone[None])
    return force, energy, pairs // 2, allowance


def barrier_radius(barrier: dict, timestep: int) -> float:
    """SphereArea: R(t) = sqrt(max(R0^2 - alpha t / (4 pi), 0))."""
    return math.sqrt(max(barrier["R0"] ** 2 - barrier["alpha"] / (4.0 * math.pi) * timestep, 0.0))


def external_forces(x, types, L, model, timestep, dtype=torch.float64):
    """(force [N, 3], energy [N]) of the harmonic barrier and the walls at
    ``timestep``'s barrier radius."""
    xw = wrap(x, L).to(dtype)
    force = torch.zeros_like(xw)
    energy = torch.zeros(xw.shape[0], dtype=dtype, device=xw.device)
    b = model.get("barrier")
    if b is not None:
        k = torch.tensor(b["k"], dtype=dtype, device=xw.device)[types]
        off = torch.tensor(b["offset"], dtype=dtype, device=xw.device)[types]
        r = torch.sqrt((xw * xw).sum(-1))
        dr = r - (barrier_radius(b, timestep) + off)
        on = dr > 0
        r_safe = torch.where(r > 0, r, 1.0)
        force = force + torch.where(on[:, None], -(k * dr / r_safe)[:, None] * xw, 0.0)
        energy = energy + torch.where(on, 0.5 * k * dr * dr, 0.0)
    for w in model.get("walls", ()):
        eps = torch.tensor(w["epsilon"], dtype=dtype, device=xw.device)[types]
        sig = torch.tensor(w["sigma"], dtype=dtype, device=xw.device)[types]
        rc = torch.tensor(w["r_cut"], dtype=dtype, device=xw.device)[types]
        normal = torch.tensor(w["normal"], dtype=torch.float64)
        normal = (normal / normal.norm()).to(dtype=dtype, device=xw.device)
        origin = torch.tensor(w["origin"], dtype=dtype, device=xw.device)
        d = ((xw - origin) * normal).sum(-1)
        inside = (d > 0) & (d * d < rc * rc)
        lj1 = (2.0 / 15.0) * eps * sig**9
        lj2 = eps * sig**3
        r2inv = 1.0 / torch.where(inside, d * d, 1.0)
        r3inv = r2inv * torch.sqrt(r2inv)
        r6inv = r3inv * r3inv
        fr = r2inv * r3inv * (9.0 * lj1 * r6inv - 3.0 * lj2)
        e = r3inv * (lj1 * r6inv - lj2)
        on = inside & (lj1 != 0)
        force = force + torch.where(on, fr * d, 0.0)[:, None] * normal
        energy = energy + torch.where(on, e, 0.0)
    return force, energy


def conservative_force(x, types, L, model, timestep, dtype=torch.float64):
    """Every force of the model at ``timestep``: (force, energy, pairs, the
    cutoff's allowance)."""
    fp, ep, pairs, allowance = pair_forces(x, types, L, model, dtype)
    fe, ee = external_forces(x, types, L, model, timestep, dtype)
    return fp + fe, ep + ee, pairs, allowance


def flow_velocity(x, L, model, dtype=torch.float64) -> torch.Tensor:
    """The method's flow velocity u(r) at the wrapped positions (zero
    without a flow): a parabolic profile u_x(y) = 1.5 U (1 - (2 y / s)^2)."""
    flow = model["method"].get("flow")
    xw = wrap(x, L).to(dtype)
    u = torch.zeros_like(xw)
    if flow is not None:
        yr = xw[:, 1] / (0.5 * flow["separation"])
        u[:, 0] = 1.5 * flow["mean_velocity"] * (1.0 - yr * yr)
    return u


def langevin_force(v_half, x, types, tags, L, model, timestep, dtype=torch.float64):
    """The Langevin force at ``timestep``: the random force
    sqrt(6 gamma kT / dt) U(-1, 1) minus the drag gamma (v - u(r))."""
    m = model["method"]
    gamma = torch.tensor(m["gamma"], dtype=dtype, device=x.device)[types][:, None]
    coef = torch.sqrt(6.0 * gamma * m["kT"] / model["dt"])
    u = threefry.uniform3(m["stream"], model["seed"], timestep, tags, dtype)
    return coef * u - gamma * (v_half.to(dtype) - flow_velocity(x, L, model, dtype))


def evaporator_pick(x, types, tags, L, model, timestep):
    """The evaporator's pick after ``timestep`` at positions ``x`` (float32
    compares against float32 bounds, as the configuration states them):
    (candidates, priorities, k). The k candidates of smallest priority
    flip; with fewer than k candidates every one flips."""
    ev = model["evaporator"]
    z = wrap(x, L)[:, 2]
    lo = float(torch.tensor(ev["lo"], dtype=torch.float32))
    hi = float(torch.tensor(ev["hi"], dtype=torch.float32))
    cand = (types == ev["solvent"]) & (z >= lo) & (z < hi)
    (prio,) = threefry.particle_words(threefry.PARTICLE_EVAPORATOR, model["seed"], timestep,
                                      tags, 1)
    return cand, prio, ev["k"]


def evaporator_fires(model: dict, timestep: int) -> bool:
    ev = model.get("evaporator")
    return ev is not None and timestep % ev["period"] == 0

"""Cell grid of the port against the JAX reference: bitwise slot layouts.

densify, rebin and undensify must reproduce the reference's slots, tags,
typeids, payload bits, overflow flag and max occupancy exactly, on random,
lattice (particles on exact cell boundaries), overfull and tilted states;
needs_rebin must make the same decision.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu.ops import dense as RD  # noqa: E402
from azplugins_tpu_torch import interop  # noqa: E402
from azplugins_tpu_torch.ops import dense as PD  # noqa: E402

torch.set_num_threads(1)


def _snap_random(box, N, seed):
    rng = np.random.default_rng(seed)
    snap = ref.Snapshot(N=N)
    snap.configuration.box = list(box)
    snap.particles.types = ["A", "B"]
    f = rng.random((N, 3)) - 0.5
    Lx, Ly, Lz, xy, xz, yz = box
    h = np.array([[Lx, xy * Ly, xz * Lz], [0, Ly, yz * Lz], [0, 0, Lz]])
    snap.particles.position[:] = f @ h.T
    snap.particles.velocity[:] = rng.normal(0, 1, (N, 3))
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.mass[:] = rng.uniform(0.5, 2, N)
    return snap


def _snap_lattice(n, rho, centred):
    """The bench's start (sites at (i + 1/2) a - L/2) or sites at i a - L/2,
    which put particles exactly on cell boundaries."""
    N = n**3
    L = (N / rho) ** (1.0 / 3.0)
    a = L / n
    snap = ref.Snapshot(N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + (0.5 if centred else 0.0)) * a - L / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    return snap


# (name, snapshot, r_cut, buffer, cap override)
CASES = {
    "random": (lambda: _snap_random((9.0, 9.0, 9.0, 0, 0, 0), 600, 1), 1.5, 0.3, None),
    "lattice": (lambda: _snap_lattice(12, 0.85, True), 2.5, 0.4, None),
    "lattice_edges": (lambda: _snap_lattice(12, 0.85, False), 2.5, 0.4, None),
    "overfull": (lambda: _snap_random((9.0, 9.0, 9.0, 0, 0, 0), 600, 2), 1.5, 0.3, 8),
    "tilted": (lambda: _snap_random((9.0, 8.0, 10.0, 0.4, -0.3, 0.2), 600, 3), 1.5, 0.3, None),
    "small_grid": (lambda: _snap_random((5.0, 9.0, 9.0, 0.1, 0, 0), 300, 4), 2.0, 0.4, None),
}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_states_equal(p, r):
    a, b = interop.state_to_numpy(r), interop.state_to_numpy(p)
    for k in a:
        np.testing.assert_array_equal(_bits(b[k]), _bits(a[k]), err_msg=k)


def _assert_meta_equal(p, r):
    carried = interop.grid_meta_from_reference(r, "cpu")
    for k in ("ref_position", "slot_of", "overflow", "n_builds", "max_occ"):
        np.testing.assert_array_equal(
            _bits(getattr(p, k).numpy()), _bits(getattr(r, k)), err_msg=k
        )
        np.testing.assert_array_equal(getattr(carried, k).numpy(), getattr(p, k).numpy())


def _setup(name):
    make, r_cut, buffer, cap = CASES[name]
    snap = make()
    rs, _, _ = ref.core.state_from_snapshot(snap)
    ps, _, _ = port.core.state_from_snapshot(snap, "cpu")
    rspec = RD.GridSpec.create(rs.box, rs.N, r_cut, buffer)
    pspec = PD.GridSpec.create(ps.box, ps.N, r_cut, buffer)
    assert pspec == interop.grid_spec_from_reference(rspec)
    if cap is not None:
        rspec, pspec = rspec.replace(cap=cap), pspec.replace(cap=cap)
    return rs, ps, rspec, pspec


@pytest.mark.parametrize("fields", [(), RD.ALL_FIELDS], ids=["core", "all_fields"])
@pytest.mark.parametrize("name", list(CASES))
def test_densify_rebin_undensify_bitwise(name, fields):
    rs, ps, rspec, pspec = _setup(name)
    rd, rm = RD.densify(rs, rspec, fields=fields)
    pd, pm = PD.densify(ps, pspec, fields=fields)
    _assert_states_equal(pd, rd)
    _assert_meta_equal(pm, rm)
    if name == "overfull":
        assert bool(pm.overflow) and int(pm.max_occ) > pspec.cap

    # drift the slot-order state (unwrapped, some particles leave the box)
    rng = np.random.default_rng(11)
    kick = rng.normal(0, 0.6, (rspec.S, 3)).astype(np.float32)
    live = np.asarray(rd.tag) >= 0
    kick[~live] = 0.0
    rd2 = rd.replace(position=rd.position + jnp.asarray(kick))
    pd2 = pd.replace(position=pd.position + torch.as_tensor(kick))
    rr, rmm = RD.rebin(rd2, rm, rspec, rs.N, fields=fields)
    pr, pmm = PD.rebin(pd2, pm, pspec, ps.N, fields=fields)
    _assert_states_equal(pr, rr)
    _assert_meta_equal(pmm, rmm)

    ru = RD.undensify(rr, rs.N, fields=fields)
    pu = PD.undensify(pr, ps.N, fields=fields)
    _assert_states_equal(pu, ru)


@pytest.mark.parametrize("name", ["random", "tilted", "small_grid"])
def test_jblocks_match(name):
    rs, ps, rspec, pspec = _setup(name)
    rd, _ = RD.densify(rs, rspec, fields=())
    pd, _ = PD.densify(ps, pspec, fields=())
    half = rspec.newton_ok
    rj = RD.make_jblocks(rd, rspec, half=half)
    pj = PD.make_jblocks(pd, pspec, half=half)
    assert (pj.half, pj.preshifted) == (rj.half, rj.preshifted)
    for k in ("x", "y", "z", "typeid"):
        np.testing.assert_array_equal(_bits(getattr(pj, k).numpy()), _bits(getattr(rj, k)))


def test_two_key_assembly_bitwise():
    """A grid whose fused key overflows int32 takes the stable two-key sort."""
    C_dims, cap, n = (16, 32, 32), 16, 1 << 17
    spec_r = RD.GridSpec(dims=C_dims, cap=cap, r_cut=1.0, buffer=0.1)
    spec_p = PD.GridSpec(dims=C_dims, cap=cap, r_cut=1.0, buffer=0.1)
    C = spec_p.n_cells
    assert (C + 1) << (n - 1).bit_length() >= 2**31
    rng = np.random.default_rng(5)
    cid = rng.integers(0, C + 1, n).astype(np.int32)  # C marks invalid rows
    layout = RD._payload_layout(())
    packed = rng.integers(-(2**31), 2**31 - 1, (n, sum(w for _, w, _ in layout))).astype(np.int32)
    n_valid = int((cid < C).sum())
    r = RD._global_assembly(jnp.asarray(packed), jnp.asarray(cid), n, spec_r, layout, n_valid)
    p = PD._global_assembly(torch.as_tensor(packed), torch.as_tensor(cid), n, spec_p,
                            PD._payload_layout(()), n_valid)
    for a, b in zip(p, r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("buffer", [0.2, 0.5, 0.9])
def test_needs_rebin_matches(buffer):
    rs, ps, rspec, pspec = _setup("random")
    rspec, pspec = rspec.replace(buffer=buffer), pspec.replace(buffer=buffer)
    rd, rm = RD.densify(rs, rspec, fields=())
    pd, pm = PD.densify(ps, pspec, fields=())
    rng = np.random.default_rng(int(buffer * 10))
    live = np.asarray(rd.tag) >= 0
    for scale, tie in [(0.01, False), (0.1, False), (0.3, True), (0.25, False)]:
        d = (rng.normal(0, scale, (rspec.S, 3)) * live[:, None]).astype(np.float32)
        if tie:  # two slots share the largest drift exactly
            i, j = np.flatnonzero(live)[:2]
            d[i] = d[j] = np.float32([0.22, 0.1, 0.0])
        r = RD.needs_rebin(rd.replace(position=rd.position + jnp.asarray(d)), rm, rspec)
        p = PD.needs_rebin(pd.replace(position=pd.position + torch.as_tensor(d)), pm, pspec,
                           torch.tensor(False))
        assert bool(p) == bool(r)

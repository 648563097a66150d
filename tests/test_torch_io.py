"""The port's IO layer against the JAX reference: the aztraj container
(native and pure-Python backends), checkpoints, and GSD export, reading
and ``create_state_from_gsd``.

The port's ``io`` is a copy of the reference's, so a file crosses between
the packages: aztraj files of the same snapshot and timestep are
byte-identical (the native and pure-Python backends of both packages write
the same bytes), a file written by either reads back in the other as equal
arrays (the MPCD solvent's ``mpcd/*`` chunks too), and GSD files differ
only in the header's application field. A checkpoint of the reference
restored in the port runs 10 steps within the bars of
tests/test_torch_simulation.py's 20-step comparison (positions within
1e-4, velocities within 1e-4 of max|v|). The MPCD checkpoint cases of
tests/test_mpcd.py and tests/test_mpcd_srd.py hold on the port as they
hold on the reference: the solvent restarts bitwise at a collision.
"""

import struct

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import azplugins_tpu as ref  # noqa: E402
import azplugins_tpu.io as rio  # noqa: E402
import azplugins_tpu_torch as port  # noqa: E402
from azplugins_tpu_torch.io import (  # noqa: E402
    TrajectoryReader,
    TrajectoryWriter,
    load_checkpoint,
    native_available,
    save_checkpoint,
)
from azplugins_tpu_torch.io import aztraj as _aztraj  # noqa: E402

torch.set_num_threads(1)


def _frames():
    rng = np.random.default_rng(3)
    return [
        (
            10 * i,
            {
                "particles/position": rng.normal(size=(17, 3)).astype(np.float32),
                "particles/typeid": rng.integers(0, 3, size=17).astype(np.int32),
                "configuration/box": np.asarray([5, 5, 5, 0, 0, 0], np.float32),
            },
        )
        for i in range(4)
    ]


def _pure_python(monkeypatch, module=_aztraj):
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(module, "_lib_tried", True)


def _roundtrip(tmp_path, name):
    path = str(tmp_path / name)
    frames = _frames()
    with TrajectoryWriter(path) as w:
        for ts, chunks in frames:
            w.write_frame(ts, chunks)
    with TrajectoryReader(path) as r:
        assert len(r) == len(frames)
        assert r.timesteps == [ts for ts, _ in frames]
        for i, (ts, chunks) in enumerate(frames):
            got_ts, got = r.read_frame(i)
            assert got_ts == ts
            assert set(got) == set(chunks)
            for k in chunks:
                np.testing.assert_array_equal(got[k], chunks[k])
    return path


def test_native_engine_builds():
    assert native_available(), "C++ aztraj engine failed to build"
    from azplugins_tpu_torch import _native

    path = _native.build_library("aztraj")
    assert path.startswith(str(_native.BUILD_DIR))  # the port's git-ignored _build/


def test_roundtrip_native(tmp_path):
    _roundtrip(tmp_path, "native.azt")


def test_roundtrip_pure_python(tmp_path, monkeypatch):
    _pure_python(monkeypatch)
    _roundtrip(tmp_path, "pure.azt")


def test_backends_interoperate(tmp_path, monkeypatch):
    """Bytes written by the native engine read back via pure python and
    vice versa — one format, two engines."""
    path = str(tmp_path / "interop.azt")
    frames = _frames()
    with TrajectoryWriter(path) as w:
        for ts, chunks in frames:
            w.write_frame(ts, chunks)
    _pure_python(monkeypatch)
    with TrajectoryReader(path) as r:
        ts, got = r.read_frame(2)
        assert ts == frames[2][0]
        np.testing.assert_array_equal(got["particles/position"], frames[2][1]["particles/position"])
    path2 = str(tmp_path / "interop2.azt")
    with TrajectoryWriter(path2) as w:
        w.write_frame(7, frames[0][1])
    monkeypatch.undo()
    assert native_available()
    with TrajectoryReader(path2) as r:
        ts, got = r.read_frame(0)
        assert ts == 7
        np.testing.assert_array_equal(got["particles/typeid"], frames[0][1]["particles/typeid"])


def test_append_mode(tmp_path):
    path = str(tmp_path / "append.azt")
    frames = _frames()
    with TrajectoryWriter(path) as w:
        w.write_frame(*frames[0])
    with TrajectoryWriter(path, mode="a") as w:
        w.write_frame(*frames[1])
    with TrajectoryReader(path) as r:
        assert len(r) == 2
        assert r.timesteps == [frames[0][0], frames[1][0]]


@pytest.mark.parametrize("backend", ["native", "pure_python"])
def test_corruption_detected(tmp_path, monkeypatch, backend):
    if backend == "pure_python":
        _pure_python(monkeypatch)
    path = _roundtrip(tmp_path, "corrupt.azt")
    raw = bytearray(open(path, "rb").read())
    raw[200] ^= 0xFF  # flip a byte inside frame data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(OSError):
        with TrajectoryReader(path) as r:
            for i in range(len(r)):
                r.read_frame(i)


# -- cross-package files ---------------------------------------------------
def _rich_snapshot(az, seed=5):
    """Two particle types, bonds, orientations, angular momenta, charges
    and an MPCD solvent, from a numpy seed."""
    rng = np.random.default_rng(seed)
    N, Ns = 12, 30
    snap = az.Snapshot(N=N, bond_N=3, mpcd_N=Ns)
    snap.configuration.box = [6.0, 7.0, 8.0, 0.1, 0.0, -0.2]
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = rng.integers(0, 2, N)
    snap.particles.position[:] = (rng.random((N, 3)) - 0.5) * [5.0, 6.0, 7.0]
    snap.particles.velocity[:] = rng.normal(size=(N, 3))
    snap.particles.image[:] = rng.integers(-2, 3, (N, 3))
    q = rng.normal(size=(N, 4))
    snap.particles.orientation[:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    snap.particles.mass[:] = rng.uniform(0.5, 2.0, N)
    snap.particles.diameter[:] = rng.uniform(0.8, 1.2, N)
    snap.particles.charge[:] = rng.normal(size=N)
    snap.particles.angmom[:] = rng.normal(size=(N, 4))
    snap.particles.moment_inertia[:] = rng.uniform(0.1, 1.0, (N, 3))
    snap.bonds.types = ["backbone", "side"]
    snap.bonds.group[:] = [[0, 1], [1, 2], [5, 9]]
    snap.bonds.typeid[:] = [0, 0, 1]
    snap.mpcd.types = ["S"]
    snap.mpcd.position[:] = (rng.random((Ns, 3)) - 0.5) * [6.0, 7.0, 8.0]
    snap.mpcd.velocity[:] = rng.normal(size=(Ns, 3))
    snap.mpcd.mass = 0.7
    return snap


def _write_azt(io_module, path, snap, timestep):
    with io_module.TrajectoryWriter(path) as w:
        w.write_frame(timestep, io_module.snapshot_to_chunks(snap, dynamic_only=False))
        w.write_frame(timestep + 5, io_module.snapshot_to_chunks(snap, dynamic_only=True))


@pytest.mark.parametrize("backend", ["native", "pure_python"])
def test_aztraj_files_are_byte_identical_across_packages(tmp_path, monkeypatch, backend):
    if backend == "pure_python":
        _pure_python(monkeypatch)
        _pure_python(monkeypatch, rio.aztraj)
    p_path, r_path = str(tmp_path / "port.azt"), str(tmp_path / "ref.azt")
    _write_azt(port.io, p_path, _rich_snapshot(port), 1234)
    _write_azt(rio, r_path, _rich_snapshot(ref), 1234)
    assert open(p_path, "rb").read() == open(r_path, "rb").read()


def test_checkpoints_are_byte_identical_across_packages(tmp_path):
    """save_checkpoint of the same state and timestep, one per package."""
    paths = {}
    for name, az in (("ref", ref), ("port", port)):
        kw = {} if az is ref else {"device": "cpu"}
        sim = az.Simulation(seed=3, **kw)
        sim.create_state_from_snapshot(_rich_snapshot(az))
        sim.timestep = 4321
        paths[name] = str(tmp_path / f"{name}.azt")
        az.io.save_checkpoint(sim, paths[name])
    assert open(paths["port"], "rb").read() == open(paths["ref"], "rb").read()


def _assert_snapshots_equal(got, want):
    np.testing.assert_array_equal(got.configuration.box, want.configuration.box)
    for field in ("position", "velocity", "image", "typeid", "orientation", "mass", "diameter",
                  "charge", "angmom", "moment_inertia"):
        np.testing.assert_array_equal(getattr(got.particles, field),
                                      getattr(want.particles, field), err_msg=field)
    assert got.particles.types == want.particles.types
    np.testing.assert_array_equal(got.bonds.group, want.bonds.group)
    np.testing.assert_array_equal(got.bonds.typeid, want.bonds.typeid)
    assert got.bonds.types == want.bonds.types


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_aztraj_reads_back_in_the_other_package(tmp_path, writer):
    w_io, r_io = (port.io, rio) if writer == "port" else (rio, port.io)
    w_az, r_az = (port, ref) if writer == "port" else (ref, port)
    path = str(tmp_path / "x.azt")
    src = _rich_snapshot(w_az)
    _write_azt(w_io, path, src, 77)
    with r_io.TrajectoryReader(path) as r:
        assert r.timesteps == [77, 82]
        ts, first = r.read_frame(0)
        _, second = r.read_frame(1)
    for name, a in w_io.snapshot_to_chunks(src).items():
        np.testing.assert_array_equal(first[name], a, err_msg=name)
    assert set(second) == set(w_io.snapshot_to_chunks(src, dynamic_only=True))
    got = r_io.chunks_to_snapshot(first)
    want = w_io.chunks_to_snapshot(w_io.snapshot_to_chunks(src))
    assert isinstance(got, r_az.Snapshot)
    _assert_snapshots_equal(got, want)
    # the MPCD solvent's chunks
    for field in ("position", "velocity", "typeid"):
        np.testing.assert_array_equal(getattr(got.mpcd, field), getattr(want.mpcd, field))
    assert got.mpcd.mass == want.mpcd.mass == np.float32(0.7)
    assert got.mpcd.types == want.mpcd.types == ["S"]
    # a dynamic frame completes from a template of either package
    dyn = r_io.chunks_to_snapshot(second, template=got)
    np.testing.assert_array_equal(dyn.particles.position, want.particles.position)


def _write_gsd(az_io, path, snap, steps):
    from importlib import import_module

    gsd = import_module(az_io.__name__ + ".gsd")
    with gsd.GSDWriter(path) as w:
        for k, step in enumerate(steps):
            chunks = az_io.snapshot_to_chunks(snap, dynamic_only=k > 0)
            for name, data in gsd._hoomd_frame_chunks(step, chunks, k == 0).items():
                w.write_chunk(name, data)
            w.end_frame()


def test_gsd_files_differ_only_in_the_application_field(tmp_path):
    p_path, r_path = str(tmp_path / "port.gsd"), str(tmp_path / "ref.gsd")
    _write_gsd(port.io, p_path, _rich_snapshot(port), (10, 20, 30))
    _write_gsd(rio, r_path, _rich_snapshot(ref), (10, 20, 30))
    p, r = bytearray(open(p_path, "rb").read()), bytearray(open(r_path, "rb").read())
    assert len(p) == len(r)
    app = slice(48, 48 + 64)  # magic, 4 u64 locations/sizes, 2 u32 versions
    assert port.io.GSDReader(p_path).application == "azplugins_tpu_torch"
    assert rio.GSDReader(r_path).application == "azplugins_tpu"
    p[app] = r[app] = b"\x00" * 64
    assert p == r


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_gsd_reads_back_in_the_other_package(tmp_path, writer):
    w_io, r_io = (port.io, rio) if writer == "port" else (rio, port.io)
    w_az = port if writer == "port" else ref
    path = str(tmp_path / "x.gsd")
    src = _rich_snapshot(w_az)
    _write_gsd(w_io, path, src, (3, 9))
    got = r_io.read_gsd(path, frame=1)
    want = w_io.read_gsd(path, frame=1)
    _assert_snapshots_equal(got, want)
    np.testing.assert_array_equal(got.particles.position,
                                  np.float32(src.particles.position))
    with r_io.GSDReader(path) as r:
        assert r.n_frames == 2
        assert int(r.read_chunk(1, "configuration/step")[0]) == 9


# -- simulations ------------------------------------------------------------
def _small_sim(az=port, seed=11, nve=False):
    n, a = 5, 1.2
    snap = az.Snapshot(N=n**3)
    snap.configuration.box = [n * a] * 3 + [0, 0, 0]
    snap.particles.types = ["A"]
    x = (np.arange(n) + 0.5) * a - n * a / 2
    snap.particles.position[:] = np.stack(np.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    kw = {} if az is ref else {"device": "cpu"}
    sim = az.Simulation(seed=seed, **kw)
    sim.create_state_from_snapshot(snap)
    _attach_lj(az, sim, nve)
    sim.state.thermalize_particle_momenta(kT=1.0)
    return sim


def _attach_lj(az, sim, nve=False):
    lj = az.pair.PerturbedLennardJones(nlist=az.md.nlist.Cell(buffer=0.4), default_r_cut=2.0)
    lj.params[("A", "A")] = dict(epsilon=1.0, sigma=1.0, attraction_scale_factor=0.5)
    method = (az.md.methods.ConstantVolume() if nve
              else az.md.methods.Langevin(kT=1.0, default_gamma=0.5))
    sim.operations.integrator = az.md.Integrator(dt=0.005, methods=[method], forces=[lj])
    return lj


def _trajectory(tmp_path, az=port):
    azt = str(tmp_path / "traj.azt")
    sim = _small_sim(az)
    traj = az.write.Trajectory(trigger=az.trigger.Periodic(10), filename=azt)
    sim.operations.writers.append(traj)
    sim.run(35)
    traj.close()
    return sim, azt


def test_gsd_export_roundtrip(tmp_path):
    """aztraj -> GSD conversion: the GSD 2.0 file round-trips through the
    independent GSDReader with the hoomd schema fields and the
    dynamic-frame fallback intact."""
    from azplugins_tpu_torch.io import GSDReader, export_gsd

    sim, azt = _trajectory(tmp_path)
    gsd_path = str(tmp_path / "traj.gsd")
    assert export_gsd(azt, gsd_path) == 3
    with GSDReader(gsd_path) as r:
        assert r.schema == "hoomd"
        assert r.schema_version == (1, 4)
        assert r.gsd_version == (2, 0)
        assert r.n_frames == 3
        names0 = set(r.chunks(0))
        for want in ("configuration/step", "configuration/box", "particles/N",
                     "particles/position", "particles/typeid", "particles/types",
                     "particles/mass", "bonds/N"):
            assert want in names0, want
        assert int(r.read_chunk(0, "configuration/step")[0]) == 10
        assert int(r.read_chunk(0, "particles/N")[0]) == 125
        trow = r.read_chunk(0, "particles/types")
        assert bytes(trow[0].astype(np.uint8)).rstrip(b"\x00") == b"A"
        names2 = set(r.chunks(2))
        assert "particles/position" in names2
        assert "particles/typeid" not in names2
        assert int(r.read_chunk(2, "configuration/step")[0]) == 30
        with TrajectoryReader(azt) as ar:
            _, raw = ar.read_frame(2)
        np.testing.assert_array_equal(r.read_chunk(2, "particles/position"),
                                      raw["particles/position"])
        np.testing.assert_allclose(r.read_chunk(0, "configuration/box")[:3], [6.0] * 3,
                                   rtol=1e-6)
    # the last frame is the live state at step 30
    assert sim.timestep == 35


def test_gsd_read_and_create_state(tmp_path):
    """read_gsd loads frames back with the dynamic fallback to frame 0, and
    create_state_from_gsd restores state and timestep well enough to run."""
    from azplugins_tpu_torch.io import export_gsd, read_gsd

    _, azt = _trajectory(tmp_path)
    gsd_path = str(tmp_path / "traj.gsd")
    export_gsd(azt, gsd_path)
    with TrajectoryReader(azt) as r:
        ts_last, last = r.read_frame(2)
        _, mid = r.read_frame(1)
    got = read_gsd(gsd_path)
    assert got.particles.N == 125
    np.testing.assert_array_equal(got.particles.position.astype(np.float32),
                                  last["particles/position"])
    assert got.particles.types == ["A"]
    np.testing.assert_array_equal(got.particles.typeid, 0)
    np.testing.assert_array_equal(got.particles.mass, 1.0)
    assert list(got.configuration.box) == [6.0, 6.0, 6.0, 0.0, 0.0, 0.0]
    got1 = read_gsd(gsd_path, frame=1)
    np.testing.assert_array_equal(got1.particles.position.astype(np.float32),
                                  mid["particles/position"])
    with pytest.raises(IndexError):
        read_gsd(gsd_path, frame=3)

    sim2 = port.Simulation(device="cpu", seed=11)
    sim2.create_state_from_gsd(gsd_path)
    assert sim2.timestep == ts_last == 30
    np.testing.assert_array_equal(
        np.asarray(sim2.state.get_snapshot().particles.position, np.float32),
        last["particles/position"])
    _attach_lj(port, sim2)
    sim2.run(5)
    assert sim2.timestep == 35


def test_create_state_from_gsd_matches_reference(tmp_path):
    """Both packages boot from one GSD file into the same state and step."""
    _, azt = _trajectory(tmp_path)
    gsd_path = str(tmp_path / "traj.gsd")
    port.io.export_gsd(azt, gsd_path)
    psim = port.Simulation(device="cpu", seed=11)
    psim.create_state_from_gsd(gsd_path, frame=1)
    rsim = ref.Simulation(seed=11)
    rsim.create_state_from_gsd(gsd_path, frame=1)
    assert psim.timestep == rsim.timestep == 20
    _assert_snapshots_equal(psim.state.get_snapshot(), rsim.state.get_snapshot())


def test_gsd_read_bonds(tmp_path):
    """Bond tables and bond type names survive the GSD round trip."""
    from azplugins_tpu_torch.io import read_gsd, snapshot_to_chunks
    from azplugins_tpu_torch.io.gsd import GSDWriter, _hoomd_frame_chunks

    snap = port.Snapshot(N=4, bond_N=3)
    snap.configuration.box = [8, 8, 8, 0, 0, 0]
    snap.particles.types = ["A", "B"]
    snap.particles.typeid[:] = [0, 1, 0, 1]
    snap.particles.position[:] = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]]
    snap.particles.mass[:] = [1.0, 2.0, 1.0, 2.0]
    snap.bonds.types = ["b-strong", "b-weak"]
    snap.bonds.group[:] = [[0, 1], [1, 2], [2, 3]]
    snap.bonds.typeid[:] = [0, 1, 0]
    path = str(tmp_path / "bonds.gsd")
    with GSDWriter(path) as w:
        for name, data in _hoomd_frame_chunks(0, snapshot_to_chunks(snap), True).items():
            w.write_chunk(name, data)
        w.end_frame()
    got = read_gsd(path)
    assert got.bonds.N == 3
    assert got.bonds.types == ["b-strong", "b-weak"]
    np.testing.assert_array_equal(got.bonds.group, snap.bonds.group)
    np.testing.assert_array_equal(got.bonds.typeid, snap.bonds.typeid)
    np.testing.assert_array_equal(got.particles.mass, snap.particles.mass)
    assert got.particles.types == ["A", "B"]


def test_gsd_writer_direct_and_append(tmp_path):
    """write.GSD appends hoomd-schema frames from the run loop, and mode="a"
    resumes a file this writer produced."""
    from azplugins_tpu_torch.io import read_gsd
    from azplugins_tpu_torch.io.gsd import GSDReader

    path = str(tmp_path / "direct.gsd")
    sim = _small_sim()
    w = port.write.GSD(trigger=port.trigger.Periodic(10), filename=path)
    sim.operations.writers.append(w)
    sim.run(25)
    w.close()
    with GSDReader(path) as r:
        assert r.n_frames == 2
        assert set(r.chunks(0)) >= {"particles/typeid", "particles/types"}
        assert "particles/typeid" not in set(r.chunks(1))
        assert int(r.read_chunk(1, "configuration/step")[0]) == 20
    sim.operations.writers.remove(w)
    w2 = port.write.GSD(trigger=port.trigger.Periodic(10), filename=path, mode="a")
    sim.operations.writers.append(w2)
    sim.run(20)
    w2.close()
    with GSDReader(path) as r:
        assert r.n_frames == 4
        assert [int(r.read_chunk(k, "configuration/step")[0]) for k in range(4)] == [
            10, 20, 30, 40]
        assert "particles/typeid" not in set(r.chunks(2))
    snap = read_gsd(path)
    assert snap.particles.N == 125
    assert snap.particles.types == ["A"]
    with GSDReader(path) as r:
        np.testing.assert_array_equal(np.asarray(snap.particles.position, np.float32),
                                      r.read_chunk(3, "particles/position"))
    assert sim.timestep == 45


def test_gsd_append_crash_safety(tmp_path):
    """An interrupted append never corrupts committed frames."""
    from azplugins_tpu_torch.io.gsd import GSDReader, GSDWriter

    path = str(tmp_path / "crash.gsd")
    with GSDWriter(path) as w:
        for k in range(3):
            w.write_chunk("configuration/step", np.asarray([k], np.uint64))
            w.write_chunk("particles/position", np.full((4, 3), k, np.float32))
            w.end_frame()
    w2 = GSDWriter(path, mode="a")
    del w2  # abandoned without close
    with GSDReader(path) as r:
        assert r.n_frames == 3
        assert int(r.read_chunk(2, "configuration/step")[0]) == 2
    w3 = GSDWriter(path, mode="a")
    assert w3.nframes == 3
    for k in range(3, 40):  # enough frames to force a slab relocation
        w3.write_chunk("configuration/step", np.asarray([k], np.uint64))
        w3.write_chunk("particles/position", np.full((4, 3), k, np.float32))
        w3.end_frame()
    w3.write_chunk("configuration/step", np.asarray([99], np.uint64))
    w3._f.flush()  # an OS-level crash: buffers drained, no close
    del w3
    with GSDReader(path) as r:
        assert r.n_frames == 40
        for k in (0, 3, 39):
            assert int(r.read_chunk(k, "configuration/step")[0]) == k
            np.testing.assert_array_equal(r.read_chunk(k, "particles/position"),
                                          np.full((4, 3), k, np.float32))
    with GSDWriter(path, mode="a") as w4:
        assert w4.nframes == 40
        w4.write_chunk("configuration/step", np.asarray([40], np.uint64))
        w4.end_frame()
    with GSDReader(path) as r:
        assert r.n_frames == 41
        assert int(r.read_chunk(40, "configuration/step")[0]) == 40


def test_gsd_append_zero_namelist_legacy(tmp_path):
    """Appending to a GSD whose header has namelist_location == 0 relocates
    a fresh namelist slab to the tail instead of looping."""
    from azplugins_tpu_torch.io.gsd import _HEADER, GSDReader, GSDWriter

    path = str(tmp_path / "legacy.gsd")
    with GSDWriter(path):
        pass
    with open(path, "r+b") as f:
        vals = list(_HEADER.unpack(f.read(_HEADER.size)))
        vals[3] = 0  # name_loc
        vals[4] = 0  # n_seg
        f.seek(0)
        f.write(_HEADER.pack(*vals))
    with GSDWriter(path, mode="a") as w:
        w.write_chunk("configuration/step", np.asarray([7], np.uint64))
        w.end_frame()
    with GSDReader(path) as r:
        assert r.n_frames == 1
        assert int(r.read_chunk(0, "configuration/step")[0]) == 7


def test_gsd_index_sorted_by_name_id(tmp_path):
    """Within each frame, index entries commit in ascending name-id order
    whatever the write_chunk order (the GSD v2 C reader binary-searches on
    (frame, id)). Checked on the raw on-disk index."""
    from azplugins_tpu_torch.io.gsd import _HEADER, _INDEX_ENTRY, GSDReader, GSDWriter

    path = str(tmp_path / "sorted.gsd")
    with GSDWriter(path) as w:
        w.write_chunk("alpha", np.asarray([1], np.uint32))
        w.write_chunk("beta", np.asarray([2], np.uint32))
        w.end_frame()
        w.write_chunk("gamma", np.asarray([3], np.uint32))
        w.write_chunk("alpha", np.asarray([4], np.uint32))
        w.write_chunk("beta", np.asarray([5], np.uint32))
        w.end_frame()
    with open(path, "rb") as f:
        (_m, index_loc, n_idx, *_rest) = _HEADER.unpack(f.read(_HEADER.size))
        f.seek(index_loc)
        disk = []
        for _ in range(n_idx):
            e = _INDEX_ENTRY.unpack(f.read(_INDEX_ENTRY.size))
            if e[2] != 0:
                disk.append((e[0], e[4]))
    assert disk == sorted(disk)
    with GSDReader(path) as r:
        assert int(r.read_chunk(1, "gamma")[0]) == 3
        assert int(r.read_chunk(1, "alpha")[0]) == 4
        assert int(r.read_chunk(1, "beta")[0]) == 5
    assert struct.calcsize("<QQqIHBB") == _INDEX_ENTRY.size == 32


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A checkpoint the reference wrote, restored in both packages and run
    10 Langevin steps: the thermostat noise is bitwise shared, so the two
    separate only through float32 rounding (the bars of the 20-step
    comparison in tests/test_torch_simulation.py)."""
    rsim = _small_sim(ref)
    rsim.run(20)
    path = str(tmp_path / "ref_ckpt.azt")
    rio.save_checkpoint(rsim, path)

    snap_r, ts_r = rio.load_checkpoint(path)
    rsim2 = _small_sim(ref)
    rsim2._set_snapshot(snap_r)
    rsim2.timestep = ts_r
    rsim2.run(10)

    snap_p, ts_p = load_checkpoint(path)
    assert ts_p == ts_r == 20
    psim = _small_sim(port)
    psim.state.set_snapshot(snap_p)
    psim.timestep = ts_p
    psim.run(10)
    r, p = rsim2.state.get_snapshot().particles, psim.state.get_snapshot().particles
    np.testing.assert_array_equal(p.image, r.image)
    np.testing.assert_allclose(p.position, r.position, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p.velocity, r.velocity, rtol=0,
                               atol=1e-4 * np.abs(r.velocity).max())


# -- the MPCD checkpoint cases of tests/test_mpcd.py and test_mpcd_srd.py --
def test_mpcd_checkpoint_roundtrip(tmp_path):
    snap = port.Snapshot(N=2, mpcd_N=3)
    snap.configuration.box = [10, 10, 10, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = [[0, 0, 0], [1, 0, 0]]
    snap.particles.velocity[:] = [[2.0, 0, 0], [0, 0, 4.0]]
    snap.particles.mass[:] = [1.0, 3.0]
    snap.mpcd.position[:] = [[-2, 0, 0], [2, 2, 0], [0, -3, 1]]
    snap.mpcd.velocity[:] = [[1, 0, 0], [1, 0, 0], [1, 0, 0]]
    snap.mpcd.mass = 0.5
    sim = port.Simulation(device="cpu", seed=3)
    sim.create_state_from_snapshot(snap)
    sim.operations.integrator = port.md.Integrator(
        dt=0.0, methods=[port.md.methods.ConstantVolume()])
    sim.run(0)
    path = str(tmp_path / "ckpt.azt")
    save_checkpoint(sim, path)
    snap, ts = load_checkpoint(path)
    assert snap.mpcd.N == 3
    np.testing.assert_allclose(snap.mpcd.position, [[-2, 0, 0], [2, 2, 0], [0, -3, 1]])
    assert snap.mpcd.mass == 0.5
    # and in the reference
    rsnap, rts = rio.load_checkpoint(path)
    assert rts == ts == 0
    np.testing.assert_array_equal(rsnap.mpcd.position, snap.mpcd.position)


def _solvent_sim(N=4000, L=8.0, seed=3):
    rng = np.random.default_rng(seed)
    snap = port.Snapshot(N=8, mpcd_N=N)
    snap.configuration.box = [L, L, L, 0, 0, 0]
    snap.particles.types = ["A"]
    snap.particles.position[:] = (rng.random((8, 3)) - 0.5) * L * 0.9
    snap.mpcd.position[:] = (rng.random((N, 3)) - 0.5) * L
    snap.mpcd.velocity[:] = rng.normal(0, 1.0, (N, 3))
    snap.mpcd.velocity[:] -= snap.mpcd.velocity.mean(axis=0)
    sim = port.Simulation(device="cpu", seed=7)
    sim.create_state_from_snapshot(snap)
    pot = port.pair.Hertz(nlist=port.md.nlist.Cell(buffer=0.4), default_r_cut=1.5)
    pot.params[("A", "A")] = dict(epsilon=1.0)
    sim.operations.integrator = port.md.Integrator(
        dt=0.02, methods=[port.md.methods.ConstantVolume()], forces=[pot])
    sim.mpcd_dynamics = port.mpcd.SRD(dt=0.02, period=5, angle=130.0, cell_size=1.0)
    return sim


def test_srd_checkpoint_roundtrip(tmp_path):
    """A checkpoint carries the advanced solvent stream; a restart at a
    collision-aligned timestep re-anchors there and reproduces the
    continuous solvent trajectory bitwise."""
    a = _solvent_sim(seed=31)
    a.run(60)
    want = torch.cat(a._mpcd["position"]).numpy()

    b = _solvent_sim(seed=31)
    b.run(30)  # 30 % period(5) == 0: collision-aligned
    assert "_srd_anchor" in b._mpcd
    path = str(tmp_path / "srd.azt")
    save_checkpoint(b, path)
    snap, ts = load_checkpoint(path)
    assert snap.mpcd.N == 4000
    c = _solvent_sim(seed=31)
    c._set_snapshot(snap)
    assert "_srd_anchor" not in c._mpcd  # the stream re-anchors at the restart
    c.timestep = ts
    c.run(30)
    np.testing.assert_array_equal(torch.cat(c._mpcd["position"]).numpy(), want)

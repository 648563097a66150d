"""The step's integrator and Verlet drift check on the card: the CUDA kernels and their wrappers.

``csrc/integrate.cu`` holds five kernels. None replaces a ``pallas_call``:
they compute what the reference leaves to XLA, which fuses it into its
step.

- K6 ``az_drift_check``: :func:`drift_check` (``ops/dense.py::needs_rebin``
  with the chunk's violation flag ORed in), :func:`drift_top_two` and
  :func:`needs_rebin_of` (the same kernel over the shards' top twos).
  Reference ``azplugins_tpu/ops/dense.py:666-686``. One launch each: a
  slot a thread, every load issued before any use, the positions staged
  through shared memory by coalesced loads, a block's top two by integer
  warp reductions on order-preserving keys; each block writes a partial
  and takes a ticket, and the last ticket's warp merges the partials.
  Over values, one warp.
- K7 ``az_step1``: :func:`step1`, ``Method.step1``'s drift half (reference
  ``azplugins_tpu/md/methods.py:68-77``).
- K7+K6 ``az_step1_drift_check``: :func:`step1_drift`, the last method's
  ``Method.step1`` on a grid path with the drift check of its new
  positions in the same launch: K7's half step as a prologue of K6 (the
  slice's velocities and accelerations staged with its positions, x'
  written back coalesced and never read again), then K6's reduction, its
  scratch and its two results (reference ``azplugins_tpu/simulation.py:
  641-652``: ``m.step1`` then ``needs_rebin``).
- K8 ``az_step2``: :func:`step2`, ``Method.step2`` (NVE) and
  ``LangevinFlow.step2`` with its draw inside (reference
  ``azplugins_tpu/md/methods.py:79-91, 172-192``): the uniforms are K4's
  bit for bit. One instantiation for each of NVE, noiseless and noisy
  Langevin, with or without a flow field and a filter; every load issued
  first, the hashes while they fly, the gamma table in shared memory.
  Its acceleration-only instance ``az_step2_accel``: :func:`step2_accel`,
  ``BrownianFlow.step2`` (reference ``azplugins_tpu/md/methods.py:
  282-289``), ``a' = F / m`` with ``v`` untouched.
- K11 ``az_brownian_step_drift_check``: :func:`brownian_step_drift`,
  ``BrownianFlow.step1`` with the drift check of its new positions in one
  launch (reference ``azplugins_tpu/md/methods.py:262-280`` then
  ``needs_rebin``): BrownianFlow's step as K6's prologue, its draw (K4's
  uniforms, bit for bit) inside, then K6's reduction, scratch and results.
  ``az_brownian_step``: :func:`brownian_step`, the step alone (an earlier
  method of several, a layout without a grid).
- K9 ``az_no_squish``: :func:`no_squish`, the NO_SQUISH rotation of
  ``Method._rot_step1`` (mode 0), ``_rot_step2`` (1) and
  ``LangevinFlow._rot_step2_langevin`` (2, its draw inside). Reference
  ``azplugins_tpu/md/rotation.py:89-146``, ``md/methods.py:94-115,
  194-228``.

Their plain PyTorch versions are the methods' and ``ops/dense.py``'s
``_plain`` functions, which the public ones take for CPU tensors; a CUDA
tensor takes these kernels or raises, and any other device raises. Every
kernel is bitwise its plain version on the card: each float operation is
rounded on its own, in the plain version's order, with the float32 scalars
PyTorch forms from the Python ones (:func:`step_args`). A launch runs on
the tensors' device and its current stream, with no synchronisation and no
host-to-device copy; outputs are new tensors (``torch.empty_like``), so a
method never writes the State it was given. Under
:func:`~azplugins_tpu_torch.core.rng.device_clock` K8 and K9 read their
draws' timestep word from the clock on the card; given kT as a 0-d tensor
on the card (a run's schedule of a variant kT), they read it there too
(:class:`Noise`), in the way they read the clock; K11 alike. An empty
layout launches nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng as _rng
from .cuda_build import load_library
from .pair_kernel import check_tensor, launch_error
from .rng_kernel import uniform_args

__all__ = [
    "launches", "launches_by_kernel", "Noise", "step_args", "drift_check", "drift_top_two",
    "needs_rebin_of", "step1", "step1_drift", "step2", "step2_accel", "brownian_step",
    "brownian_step_drift", "no_squish",
]

# kernel launches since import (or since a caller last reset them to 0):
# in all, and by kernel ("drift_check" K6, "step1" K7, "step1_drift" K7
# and K6 in one launch, "step2" K8 (its acceleration-only instance too),
# "no_squish" K9, "brownian_step" K11 alone, "brownian_step_drift" K11 and
# K6 in one launch)
launches = 0
launches_by_kernel: dict[str, int] = {}

_SOURCE = "integrate.cu"


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    if lib.az_drift_check.argtypes is None:
        p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
        lib.az_drift_check.argtypes = [p, p, p, p, i, f, p, p, p, p, p, p]
        lib.az_step1.argtypes = [p, p, p, p, p, i, f, f, p, p, p]
        lib.az_step1_drift_check.argtypes = [p, p, p, p, p, p, i, f, f, f, p, p, p, p, p, p, p,
                                             p]
        lib.az_step2.argtypes = [p, p, p, p, p, p, p, p, i, f, p, i, i, u, u, p, i, f, f, f, p,
                                 f, p, p, p]
        lib.az_no_squish.argtypes = [i, p, p, p, p, p, p, p, i, f, f, p, i, i, u, u, p, i, f, f,
                                     f, p, f, p, p, p, p]
        lib.az_step2_accel.argtypes = [p, p, p, p, p, i, p, p]
        lib.az_brownian_step.argtypes = [p, p, p, p, p, p, i, f, p, i, i, u, u, p, i, f, f, f, p,
                                         f, p, p]
        lib.az_brownian_step_drift_check.argtypes = [p, p, p, p, p, p, p, i, f, f, p, i, i, u, u,
                                                     p, i, f, f, f, p, f, p, p, p, p, p, p, p]
        lib.az_drift_max_blocks.argtypes = []
        for fn in (lib.az_drift_check, lib.az_step1, lib.az_step1_drift_check, lib.az_step2,
                   lib.az_step2_accel, lib.az_brownian_step, lib.az_brownian_step_drift_check,
                   lib.az_no_squish, lib.az_drift_max_blocks):
            fn.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, entry: str, dev: torch.device, *args) -> None:
    """Call the C entry point ``entry`` on ``dev``'s current stream, with
    ``dev`` current (a shard may lie on another card); raise on its CUDA
    error, else count one launch of ``kernel``."""
    global launches
    lib = _library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, entry, err)
    launches += 1
    launches_by_kernel[kernel] = launches_by_kernel.get(kernel, 0) + 1


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the integrator kernels need CUDA tensors, got {t.device}")
    if t.shape[0] >= 2**31 // 4:
        raise ValueError(f"{t.shape[0]} slots exceed the kernels' int32 index")
    return t.device


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _checked(t: torch.Tensor, name: str, dtype, shape, dev) -> torch.Tensor:
    t = t.contiguous()
    check_tensor(t, name, dtype, shape, dev)
    return t


def _select(sel: torch.Tensor | None, n: int, dev) -> torch.Tensor | None:
    return None if sel is None else _checked(sel, "sel", torch.bool, (n,), dev)


class Noise(NamedTuple):
    """A Langevin or Brownian force's parameters: the ``[T]`` float32 gamma
    table on the slots' device, the draw's stream, seed and timestep, kT and
    whether its noise acts (``noisy``: not noiseless and dt > 0; K11 draws
    either way and scales the uniforms by +0 without it). kT is a Python
    float (the host-kT form: its float32 is a launch argument) or a 0-d
    float32 tensor on the slots' device (the device-kT form: the kernel
    reads it through a pointer, so a CUDA graph reads each replay's value;
    the same bits)."""

    table: torch.Tensor
    stream: int
    seed: int
    timestep: int
    kT: float | torch.Tensor
    noisy: bool


def step_args(dt: float) -> tuple[float, float, float]:
    """The float32 ``(0.5 * dt, dt, 1 / dt)`` the plain version multiplies
    by on the card: PyTorch rounds the Python scalars ``0.5 * dt`` and
    ``dt`` (formed in double) to float32, and divides a tensor by the
    Python scalar ``dt`` as a product with ``float32(1.0 / dt)`` (the
    reciprocal formed in double)."""
    inv = float(np.float32(1.0 / dt)) if dt != 0 else float("inf")
    return float(np.float32(0.5 * dt)), float(np.float32(dt)), inv


def _kT_args(kT, dev) -> tuple:
    """``(kT, kT_dev)``: the host-kT form's float32 and a null pointer, or
    for a 0-d float32 tensor on ``dev`` (the device-kT form) 0.0 and its
    pointer."""
    if isinstance(kT, torch.Tensor):
        check_tensor(kT, "kT", torch.float32, (), dev)
        return 0.0, kT.data_ptr()
    return float(np.float32(kT)), None


def _noise_args(noise: Noise | None, dev, dt: float) -> tuple:
    """The C arguments (gamma, n_types, noisy, k0, k1, clock, offset, width,
    low, kT, kT_dev, inv_dt) of ``noise``, or of no Langevin force. Under
    :func:`~azplugins_tpu_torch.core.rng.device_clock` the kernel reads the
    key's timestep word from the clock on the card; with a tensor kT it
    reads kT from the card."""
    if noise is None:
        return (None, 0, 0, 0, 0, None, 0, 0.0, 0.0, 0.0, None, 0.0)
    table = _checked(noise.table, "gamma", torch.float32, (noise.table.numel(),), dev)
    k0, k1 = _rng._key_words(noise.stream, noise.seed, noise.timestep)
    width, low = uniform_args(-1.0, 1.0)
    return (table.data_ptr(), table.numel(), int(noise.noisy), k0, k1,
            *_rng._clock_args(noise.timestep, dev), width, low, *_kT_args(noise.kT, dev),
            step_args(dt)[2])


# -- K6 ----------------------------------------------------------------------
# device -> (partials, counter): the last-block-done scratch, the counter
# zeroed once here and reset by the kernel's last block. One a device: the
# port runs its drift checks one after another on a device, eagerly or in a
# CUDA graph replayed on the same stream, so a capture (on its own stream)
# reuses the scratch and allocates nothing
_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def _drift_scratch(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = torch.device(dev)
    got = _scratch.get(key)
    if got is None:
        blocks = _library().az_drift_max_blocks()
        got = (torch.empty((blocks, 2), dtype=torch.float32, device=dev),
               torch.zeros((1,), dtype=torch.int32, device=dev))
        _scratch[key] = got
    return got


def _drift_launch(position, ref_position, tag, values, buffer, viol, top2) -> None:
    src = position if values is None else values
    dev = _device(src)
    if values is None:
        n = tag.numel()
        position = _checked(position, "position", torch.float32, (n, 3), dev)
        ref_position = _checked(ref_position, "ref_position", torch.float32, (n, 3), dev)
        tag = _checked(tag, "tag", torch.int32, (n,), dev)
    else:
        n = values.numel()
        values = _checked(values, "values", torch.float32, (n,), dev)
    if n == 0:
        raise ValueError("the drift check needs at least one slot")
    partials, counter = _drift_scratch(dev)
    viol_in, viol_out = viol if viol is not None else (None, None)
    if viol_in is not None:
        check_tensor(viol_in, "viol", torch.bool, (), dev)
    _launch("drift_check", "az_drift_check", dev, _ptr(position), _ptr(ref_position), _ptr(tag),
            _ptr(values), n, float(np.float32(buffer)), _ptr(viol_in), _ptr(viol_out), _ptr(top2),
            partials.data_ptr(), counter.data_ptr())


def drift_check(position, ref_position, tag, buffer: float, viol: torch.Tensor) -> torch.Tensor:
    """``viol | needs_rebin``: the 0-d bool ``viol`` ORed with whether the
    two largest squared drifts of ``position`` from ``ref_position`` (0 on
    slots with tag < 0) exceed ``buffer`` as ``sqrt(m1) + sqrt(m2)``; false
    for a NaN drift. One launch."""
    out = torch.empty((), dtype=torch.bool, device=position.device)
    _drift_launch(position, ref_position, tag, None, buffer, (viol, out), None)
    return out


def drift_top_two(position, ref_position, tag) -> torch.Tensor:
    """[2]: the two largest squared drifts, ties counted (NaN, NaN with a
    NaN drift). One launch."""
    out = torch.empty((2,), dtype=torch.float32, device=position.device)
    _drift_launch(position, ref_position, tag, None, 0.0, None, out)
    return out


def needs_rebin_of(tops: torch.Tensor, buffer: float, viol: torch.Tensor) -> torch.Tensor:
    """``viol | needs_rebin_of(tops)``: the criterion over the shards' top
    twos, each a squared drift (+0 or more), -inf or NaN, as
    :func:`drift_top_two` gives them. One launch of one warp."""
    out = torch.empty((), dtype=torch.bool, device=tops.device)
    _drift_launch(None, None, None, tops.reshape(-1), buffer, (viol, out), None)
    return out


# -- K7, K7+K6, K8 ------------------------------------------------------------
def step1(tag, sel, position, velocity, acceleration, dt: float) -> tuple:
    """``(position, velocity)`` after the drift half step, under the mask
    ``tag >= 0`` (and ``sel``, a filter's bool, where given)."""
    dev = _device(position)
    n = tag.numel()
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    x, v, a = (_checked(t, name, torch.float32, (n, 3), dev) for t, name in
               ((position, "position"), (velocity, "velocity"),
                (acceleration, "acceleration")))
    sel = _select(sel, n, dev)
    x_out, v_out = torch.empty_like(x), torch.empty_like(v)
    if n:
        half, dt32, _ = step_args(dt)
        _launch("step1", "az_step1", dev, tag.data_ptr(), _ptr(sel), x.data_ptr(), v.data_ptr(),
                a.data_ptr(), n, half, dt32, x_out.data_ptr(), v_out.data_ptr())
    return x_out, v_out


def step1_drift(tag, sel, position, velocity, acceleration, dt: float, ref_position,
                buffer: float, viol: torch.Tensor | None = None) -> tuple:
    """K7 then K6 in one launch: ``(position, velocity, result)``, the
    positions and velocities :func:`step1` gives and the drift check of
    those positions from ``ref_position``: ``result`` is the 0-d bool
    ``viol | needs_rebin`` (as :func:`drift_check`) or, with ``viol`` None,
    the ``[2]`` two largest squared drifts (as :func:`drift_top_two`)."""
    dev = _device(position)
    n = tag.numel()
    if n == 0:
        raise ValueError("the drift check needs at least one slot")
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    x, v, a, r = (_checked(t, name, torch.float32, (n, 3), dev) for t, name in
                  ((position, "position"), (velocity, "velocity"),
                   (acceleration, "acceleration"), (ref_position, "ref_position")))
    sel = _select(sel, n, dev)
    x_out, v_out = torch.empty_like(x), torch.empty_like(v)
    out, viol_in, viol_out, top2 = _drift_result(viol, dev)
    partials, counter = _drift_scratch(dev)
    half, dt32, _ = step_args(dt)
    _launch("step1_drift", "az_step1_drift_check", dev, tag.data_ptr(), _ptr(sel), x.data_ptr(),
            v.data_ptr(), a.data_ptr(), r.data_ptr(), n, half, dt32, float(np.float32(buffer)),
            _ptr(viol_in), _ptr(viol_out), _ptr(top2), x_out.data_ptr(), v_out.data_ptr(),
            partials.data_ptr(), counter.data_ptr())
    return x_out, v_out, out


def _drift_result(viol: torch.Tensor | None, dev) -> tuple:
    """``(out, viol_in, viol_out, top2)``: the fused launches' result, the
    0-d bool verdict ORed with ``viol`` or, with ``viol`` None, the ``[2]``
    two largest squared drifts, and the pointers' tensors for it."""
    if viol is None:
        out = torch.empty((2,), dtype=torch.float32, device=dev)
        return out, None, None, out
    check_tensor(viol, "viol", torch.bool, (), dev)
    out = torch.empty((), dtype=torch.bool, device=dev)
    return out, viol, out, None


def step2(tag, sel, typeid, velocity, acceleration, net_force, mass, dt: float,
          noise: Noise | None = None, flow: torch.Tensor | None = None) -> tuple:
    """``(velocity, acceleration)`` after the kick half step: NVE without
    ``noise``, else the Langevin force (drag relative to ``flow``, the flow
    velocity [n, 3], where given)."""
    dev = _device(velocity)
    n = tag.numel()
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    typeid = _checked(typeid, "typeid", torch.int32, (n,), dev)
    v, a, f = (_checked(t, name, torch.float32, (n, 3), dev) for t, name in
               ((velocity, "velocity"), (acceleration, "acceleration"), (net_force, "net_force")))
    mass = _checked(mass, "mass", torch.float32, (n,), dev)
    if flow is not None:
        if flow.dtype != torch.float32:
            raise TypeError(f"the flow velocity has dtype {flow.dtype}, expected torch.float32")
        flow = _checked(flow.expand(n, 3), "flow", torch.float32, (n, 3), dev)
    sel = _select(sel, n, dev)
    v_out, a_out = torch.empty_like(v), torch.empty_like(a)
    if n:
        _launch("step2", "az_step2", dev, tag.data_ptr(), _ptr(sel), typeid.data_ptr(),
                v.data_ptr(), a.data_ptr(), f.data_ptr(), mass.data_ptr(), _ptr(flow), n,
                step_args(dt)[0], *_noise_args(noise, dev, dt), v_out.data_ptr(),
                a_out.data_ptr())
    return v_out, a_out


def step2_accel(tag, sel, acceleration, net_force, mass) -> torch.Tensor:
    """BrownianFlow's step2: the acceleration ``net_force / mass`` under the
    mask ``tag >= 0`` (and ``sel``), the old acceleration elsewhere; K8's
    acceleration-only instance."""
    dev = _device(acceleration)
    n = tag.numel()
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    a, f = (_checked(t, name, torch.float32, (n, 3), dev) for t, name in
            ((acceleration, "acceleration"), (net_force, "net_force")))
    mass = _checked(mass, "mass", torch.float32, (n,), dev)
    sel = _select(sel, n, dev)
    a_out = torch.empty_like(a)
    if n:
        _launch("step2", "az_step2_accel", dev, tag.data_ptr(), _ptr(sel), a.data_ptr(),
                f.data_ptr(), mass.data_ptr(), n, a_out.data_ptr())
    return a_out


# -- K11 ---------------------------------------------------------------------
def _brownian_inputs(tag, sel, typeid, position, net_force, noise: Noise, flow) -> tuple:
    """The checked inputs of K11: ``(dev, n, tag, sel, typeid, x, F, flow)``,
    the flow velocity expanded to ``[n, 3]`` (or None)."""
    if noise is None:
        raise ValueError("BrownianFlow's step needs its Noise (the gamma table and the draw)")
    dev = _device(position)
    n = tag.numel()
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    typeid = _checked(typeid, "typeid", torch.int32, (n,), dev)
    x, f = (_checked(t, name, torch.float32, (n, 3), dev) for t, name in
            ((position, "position"), (net_force, "net_force")))
    if flow is not None:
        if flow.dtype != torch.float32:
            raise TypeError(f"the flow velocity has dtype {flow.dtype}, expected torch.float32")
        flow = _checked(flow.expand(n, 3), "flow", torch.float32, (n, 3), dev)
    return dev, n, tag, _select(sel, n, dev), typeid, x, f, flow


def brownian_step(tag, sel, typeid, position, net_force, dt: float, noise: Noise,
                  flow: torch.Tensor | None = None) -> torch.Tensor:
    """BrownianFlow's step1: the positions ``x + (u + (F + c U) / gamma) dt``
    under the mask ``tag >= 0`` (and ``sel``), with gamma the table of
    ``noise`` by the clamped ``typeid``, ``c = sqrt(6 gamma kT / dt)`` (+0
    without noise), U K4's three uniforms in [-1, 1) and u the flow velocity
    ``flow`` [n, 3] (+0 where None)."""
    dev, n, tag, sel, typeid, x, f, flow = _brownian_inputs(tag, sel, typeid, position,
                                                            net_force, noise, flow)
    x_out = torch.empty_like(x)
    if n:
        _launch("brownian_step", "az_brownian_step", dev, tag.data_ptr(), _ptr(sel),
                typeid.data_ptr(), x.data_ptr(), f.data_ptr(), _ptr(flow), n,
                step_args(dt)[1], *_noise_args(noise, dev, dt), x_out.data_ptr())
    return x_out


def brownian_step_drift(tag, sel, typeid, position, net_force, dt: float, noise: Noise,
                        flow, ref_position, buffer: float,
                        viol: torch.Tensor | None = None) -> tuple:
    """K11: :func:`brownian_step` and the drift check of its positions from
    ``ref_position`` in one launch, ``(position, result)``: ``result`` is
    the 0-d bool ``viol | needs_rebin`` (as :func:`drift_check`) or, with
    ``viol`` None, the ``[2]`` two largest squared drifts (as
    :func:`drift_top_two`)."""
    dev, n, tag, sel, typeid, x, f, flow = _brownian_inputs(tag, sel, typeid, position,
                                                            net_force, noise, flow)
    if n == 0:
        raise ValueError("the drift check needs at least one slot")
    r = _checked(ref_position, "ref_position", torch.float32, (n, 3), dev)
    x_out = torch.empty_like(x)
    out, viol_in, viol_out, top2 = _drift_result(viol, dev)
    partials, counter = _drift_scratch(dev)
    _launch("brownian_step_drift", "az_brownian_step_drift_check", dev, tag.data_ptr(),
            _ptr(sel), typeid.data_ptr(), x.data_ptr(), f.data_ptr(), _ptr(flow), r.data_ptr(), n,
            step_args(dt)[1], float(np.float32(buffer)), *_noise_args(noise, dev, dt),
            _ptr(viol_in), _ptr(viol_out), _ptr(top2), x_out.data_ptr(), partials.data_ptr(),
            counter.data_ptr())
    return x_out, out


# -- K9 ----------------------------------------------------------------------
def no_squish(mode: int, tag, sel, typeid, orientation, angmom, moment_inertia, torque,
              dt: float, noise: Noise | None = None) -> tuple:
    """The NO_SQUISH rotation. Mode 0 (step1: kick with ``torque``, free
    rotation): ``(orientation, angmom)``; mode 1 (step2's kick):
    ``(angmom,)``; mode 2 (Langevin's step2, ``noise`` holding gamma_r and
    the LANGEVIN_ANGULAR stream): ``(angmom, torque)``, the torque with the
    body-frame Langevin torque added."""
    if mode not in (0, 1, 2) or (mode == 2) != (noise is not None):
        raise ValueError(f"no_squish: mode {mode} with noise {noise is not None}")
    dev = _device(orientation)
    n = tag.numel()
    tag = _checked(tag, "tag", torch.int32, (n,), dev)
    typeid = _checked(typeid, "typeid", torch.int32, (n,), dev)
    q = _checked(orientation, "orientation", torch.float32, (n, 4), dev)
    p = _checked(angmom, "angmom", torch.float32, (n, 4), dev)
    inertia = _checked(moment_inertia, "moment_inertia", torch.float32, (n, 3), dev)
    t = _checked(torque, "torque", torch.float32, (n, 3), dev)
    sel = _select(sel, n, dev)
    q_out = torch.empty_like(q) if mode == 0 else None
    p_out = torch.empty_like(p)
    t_out = torch.empty_like(t) if mode == 2 else None
    if n:
        half, dt32, _ = step_args(dt)
        _launch("no_squish", "az_no_squish", dev, mode, tag.data_ptr(), _ptr(sel),
                typeid.data_ptr(), q.data_ptr(), p.data_ptr(), inertia.data_ptr(), t.data_ptr(),
                n, dt32, half, *_noise_args(noise, dev, dt), _ptr(q_out), p_out.data_ptr(),
                _ptr(t_out))
    return {0: (q_out, p_out), 1: (p_out,), 2: (p_out, t_out)}[mode]

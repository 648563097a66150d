"""Pair force on the dense cell grid: the CUDA kernel, its wrapper, dispatch.

The kernel, ``csrc/cell_pair_force.cu``, replaces the TPU kernel
``azplugins_tpu/ops/pallas_pair.py::stencil_pair_force_kernel`` as reached
through ``azplugins_tpu/ops/dense.py::_pallas_half_pair_force``: the
PLJ/LJ force-only fast path on the step path, and the general evaluator for
every isotropic potential of ops/evaluators/pair.py (:data:`KERNEL_POTENTIALS`)
in modes none/shift/xplor, with per-slot energy and virial for observables
(``want="all"``). Its plain PyTorch version is
:func:`azplugins_tpu_torch.ops.dense.dense_pair_force`.

What bounds it on an H100. At the 262,144 headline (19^3 cells of ~38
particles, r_cut 3.0 in cells 3.56 wide) each slot has ~1,000 occupied
candidates in its 27 neighbour cells, of which ~96 fall inside the cutoff,
and every pair is evaluated from both of its sides (twice the half
stencil's work). The cutoff test costs ~20 instructions per candidate (a
shared-memory read, the explicitly rounded separation, the compare, the
list append, the loop); a pair inside costs ~40 more (~30 float32
operations of PLJ; an exp or a sqrt more for the Yukawa, Morse, Gaussian
and Hertz forms). Instruction issue, not FLOPs, is what binds: in the
sweep over every candidate the filter took half the call. Measured times
are in PERF.md.

What the design does about it (the packed schedule of
``csrc/cell_stencil.cuh``): one 256-thread block per cell stages the
occupied slots of its whole stencil in shared memory once, so every loop
runs to the cells' occupancy, not to ``cap``; the cell's occupied slots
share the block's lanes (K = 256 // n_i lanes each, their partial sums
added in lane order); each lane first only tests the distance of its
candidates and lists the hits, then evaluates the list, so the evaluation
runs only where a lane has a pair. The tables sit in shared memory where
they fit. Stencils with more candidates than the staging buffer holds
(``kStageBytes``) are staged in rounds. Accumulation stays in registers
with no atomics, so two launches on the same input give the same bits.
The potential is a compile-time choice and the shift mode is folded into
the tables (:func:`kernel_tables`).

Verlet pair lists (:class:`PairList`): inside a rebuild segment on the
card (``Simulation._run_segment``) a build (:func:`build_pair_list`) lists,
once a segment, each lane's candidates within the largest cutoff plus the
Verlet buffer at the layout's last rebuild (:func:`list_rsq`); the
segment's force-only calls sweep those lists instead of every candidate,
bitwise the same forces, as long as the drift check holds. Calls outside a
segment (observables, the first force) sweep every candidate. Newton
halving with a j-side pass is a later measurement.

The kernels take the slot layout :func:`~.dense.densify` builds, each
cell's occupied slots first; a cell whose stencil holds another layout
gets NaN outputs, never a silently dropped pair. On a sharded mesh a
launch takes a shard's halo window (:class:`~.dense.Window`): it reads the
window's slots and computes, and writes, the shard's own columns only; a
cell whose stencil leaves the window gets NaN outputs too.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.state import State
from .cuda_build import load_library
from .dense import GridSpec, Window, dense_pair_force, make_jblocks
from .evaluators.pair import PAIR_POTENTIALS
from .pair_force import ForceResult

__all__ = [
    "launches", "launches_by_potential", "list_builds", "KERNEL_POTENTIALS", "kernel_tables",
    "cell_pair_force", "pair_force", "PairList", "lists_apply", "list_capacity", "list_rsq",
    "build_pair_list",
]

# kernel launches since import (or since a caller last reset them to 0):
# in all, and per potential (each potential is its own kernel instantiation);
# the pair-list builds (:func:`build_pair_list`) apart, since they compute no
# force: ``launches`` counts the force calls, list sweeps among them
launches = 0
launches_by_potential: dict[str, int] = {}
list_builds = 0

_SOURCE = "cell_pair_force.cu"
# potential name -> its parameter tables in the order the kernel reads them;
# the position of the name is the kernel's potential id (csrc enum Pot)
KERNEL_POTENTIALS = {
    "PerturbedLennardJones": ("lj1", "lj2", "lam", "rwcasq", "wca_shift"),
    "LJ": ("lj1", "lj2"),
    "Colloid": ("A", "a_1", "a_2", "sigma_3"),
    "ExpandedYukawa": ("epsilon", "kappa", "delta"),
    "Hertz": ("epsilon",),
    "Morse": ("D0", "alpha", "r0"),
    "Gaussian": ("epsilon", "sig2inv"),
    "Yukawa": ("epsilon", "kappa"),
}
_POTENTIAL_ID = {name: i for i, name in enumerate(KERNEL_POTENTIALS)}
_NAME_OF_EVALUATOR = {PAIR_POTENTIALS[n].energy_force: n for n in KERNEL_POTENTIALS}
_N_LEAD = 3  # rcutsq, ecut, ronsq precede the parameters (csrc enum Tab)
_NO_KERNEL = (
    "no CUDA pair kernel for this potential: every isotropic potential runs in "
    "csrc/cell_pair_force.cu, the anisotropic TwoPatchMorse in csrc/cell_aniso_force.cu "
    "(ops/aniso_kernel.py)"
)


def kernel_tables(potential: str, params: dict, r_cut: torch.Tensor,
                  r_on: torch.Tensor | None = None, mode: str = "none") -> torch.Tensor:
    """Stack one potential's tables for the kernel: ``[3 + n, T, T]`` float32.

    Rows: ``rcutsq``, the energy offset ``ecut``, the squared xplor
    switch-on radius ``ronsq``, then the potential's parameters in
    :data:`KERNEL_POTENTIALS` order. The mode lives in the first three:
    "none" has ecut 0 and ronsq +inf; "shift" has ecut = the pair energy
    at the cutoff (evaluated by the plain evaluator, as the plain version
    does) and ronsq +inf; "xplor" smooths above r_on where r_on < r_cut
    (ecut 0, ronsq r_on^2) and shifts plainly elsewhere, HOOMD's rule.
    """
    if potential not in KERNEL_POTENTIALS:
        raise NotImplementedError(_NO_KERNEL)
    rcutsq = r_cut * r_cut
    ecut, _ = PAIR_POTENTIALS[potential].energy_force(
        torch.where(rcutsq > 0, rcutsq, 4.0), rcutsq, params
    )
    zero = torch.zeros_like(rcutsq)
    inf = torch.full_like(rcutsq, math.inf)
    if mode == "none":
        ecut, ronsq = zero, inf
    elif mode == "shift":
        ronsq = inf
    elif mode == "xplor":
        smooth = r_on < r_cut
        ecut = torch.where(smooth, zero, ecut)
        ronsq = torch.where(smooth, r_on * r_on, inf)
    else:
        raise ValueError(f"unknown shift mode {mode!r}")
    rows = [rcutsq, ecut, ronsq] + [params[k] for k in KERNEL_POTENTIALS[potential]]
    return torch.stack(rows).to(torch.float32).contiguous()


def _library() -> ctypes.CDLL:
    lib = load_library(_SOURCE)
    fn = lib.az_cell_pair_force
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p, p, p, p, i, i, i, i, i, i, i, i, i] + [f] * 9
                       + [i, i, i, i, p, p, p, p, p, p, p, i, i, p])
        fn.restype = ctypes.c_int
        lib.az_cell_pair_list.argtypes = ([p, p, p, i, i, i, i, i, i, i, i, i] + [f] * 9
                                          + [i, f, p, p, p, p, p, i, i, p])
        lib.az_cell_pair_list.restype = ctypes.c_int
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        lib.az_cuda_error_string.restype = ctypes.c_char_p
    return lib


# a K1 block's threads (csrc kThreads): one column of a block's lists a thread
LIST_LANES = 256
# ints of a block's stencil plan (csrc az::kPlanInts: az::StencilPlan's four
# scalars, five arrays of 27 and two of 28), which a build keeps for its sweeps
PLAN_INTS = 4 + 5 * 27 + 2 * 28


def lists_apply(device) -> bool:
    """Whether K1's force calls on ``device`` sweep Verlet pair lists inside
    a rebuild segment: on the card (the plain version on the CPU sweeps
    every candidate)."""
    return torch.device(device).type == "cuda"


def list_capacity(cap: int) -> int:
    """Entries a lane's pair list holds on a grid of ``cap`` slots a cell
    (csrc ``az::PairList::cap_e``). The list radius is at most a cell's
    edge, so at full occupancy a slot's list holds at most the 4 pi / 3 cap
    particles of a sphere one edge wide, shared by the fewest lanes a slot
    of a full cell gets (256 // cap); a quarter more for the fluctuations
    of a liquid, a multiple of 8. A lane whose list outgrows it makes its
    block sweep every candidate until the next build. A cell of more than
    256 slots always does (its slots take several i rounds), so the sizing
    stops there."""
    c = min(int(cap), LIST_LANES)
    share = 1.25 * (4.0 * math.pi / 3.0) * c / (LIST_LANES // c)
    return 8 * math.ceil(share / 8)


def list_rsq(r_max: float, buffer: float, box) -> float:
    """The squared list radius of a force whose largest cutoff is ``r_max``
    on a grid of Verlet ``buffer``: a pair inside any cutoff at a step that
    passes the drift check (the two largest drifts since the rebuild sum to
    at most ``buffer``) was within ``r_max + buffer`` at the rebuild. The
    margins cover float32 rounding: 1e-5 of the radius, and 2**-20 of the
    box's widest extent for the positions' own rounding (the lattice shifts
    add a box length to a coordinate)."""
    extent = max(box.Lx, box.Ly, box.Lz) * (1.0 + abs(box.xy) + abs(box.xz) + abs(box.yz))
    r = (r_max + buffer) * (1.0 + 1e-5) + 2.0**-20 * extent
    return r * r


class PairList:
    """K1's Verlet pair lists on a whole layout of grid ``spec``: device
    buffers sized from it (csrc ``az::PairList``), one list a lane of each
    cell's block, :func:`list_capacity` entries each, and each block's
    stencil plan. :func:`build_pair_list` fills them from the rebuild's
    positions; :func:`cell_pair_force` sweeps them (force only). Every block
    sweeps every candidate until the first build. ``n_fallback``: a 0-d
    int64 tensor on ``device`` into which each build adds the blocks that
    fall back (the tracer's)."""

    def __init__(self, spec: GridSpec, device, n_fallback: torch.Tensor):
        self.spec = spec
        self.cap_e = list_capacity(spec.cap)
        n = spec.n_cells
        self.entries = torch.empty((n, self.cap_e, LIST_LANES), dtype=torch.int16, device=device)
        self.counts = torch.zeros((n, LIST_LANES), dtype=torch.int16, device=device)
        self.fallback = torch.ones((n,), dtype=torch.int32, device=device)
        self.plans = torch.empty((n, PLAN_INTS), dtype=torch.int32, device=device)
        check_tensor(n_fallback, "n_fallback", torch.int64, (), self.entries.device)
        self.n_fallback = n_fallback

    def tensors(self) -> list[torch.Tensor]:
        """The buffers a build writes."""
        return [self.entries, self.counts, self.fallback, self.plans, self.n_fallback]

    def check(self, spec: GridSpec, device) -> None:
        """Raise unless the lists were sized for ``spec`` on ``device``."""
        if spec != self.spec:
            raise ValueError(f"pair lists of grid {self.spec} used on grid {spec}")
        if self.entries.device != device:
            raise ValueError(f"pair lists on {self.entries.device} used on {device}")


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and layout a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_window(dense: State, spec: GridSpec, window: Window | None) -> tuple:
    """What a cell kernel reads and writes: ``(state, (w0, n_cols, c0,
    n_own), S_in, S_out)``, the window's slots and its own columns, or the
    whole grid (``window`` None)."""
    cols, per_col = spec.dims[0] * spec.dims[1], spec.dims[2] * spec.cap
    if window is None:
        return dense, (0, cols, 0, cols), spec.S, spec.S
    geom = (window.w0, window.n_cols, window.c0, window.n_own)
    return window.state, geom, window.n_cols * per_col, window.n_own * per_col


def check_cell_args(fn: str, dense: State, spec: GridSpec, want: str, S: int) -> torch.device:
    """The checks every cell kernel shares (``S``: the slots it reads);
    returns the CUDA device."""
    dev = dense.position.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    if want not in ("force", "all"):
        raise ValueError(f"want must be 'force' or 'all', got {want!r}")
    if spec.cap > 1024:
        raise ValueError(f"cell capacity {spec.cap} exceeds the cell kernels' 1024 slots per cell")
    check_tensor(dense.position, "position", torch.float32, (S, 3), dev)
    check_tensor(dense.typeid, "typeid", torch.int32, (S,), dev)
    check_tensor(dense.tag, "tag", torch.int32, (S,), dev)
    return dev


def box_args(dense: State) -> tuple:
    """The nine box floats both cell kernels take (csrc BoxArgs order)."""
    box = dense.box
    return (box.Lx, box.Ly, box.Lz, box.xy, box.xz, box.yz, *box.lattice_products())


def launch_error(lib: ctypes.CDLL, fn: str, err: int) -> RuntimeError:
    msg = lib.az_cuda_error_string(err).decode()
    return RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def cell_pair_force(dense: State, spec: GridSpec, tables: torch.Tensor, potential: str,
                    mode: str, want: str = "force", window: Window | None = None,
                    pair_list: PairList | None = None) -> ForceResult:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    ``tables`` comes from :func:`kernel_tables` for ``potential`` and
    ``mode`` (the tables carry the mode; ``mode`` selects the instantiation
    that reads the xplor row). Returns per-slot force ``[S, 3]``, plus
    energy ``[S]`` and virial ``[S, 6]`` when ``want="all"``; with a
    ``window``, read from ``window.state``, for its own slots. With a
    ``pair_list`` (force only, a whole layout) built on this layout since
    its last rebuild, by positions that have passed the drift check since,
    each block sweeps its lists where they hold: bitwise the forces of the
    sweep over every candidate.
    """
    global launches
    src, geom, S_in, S = launch_window(dense, spec, window)
    dev = check_cell_args("cell_pair_force", src, spec, want, S_in)
    if pair_list is not None:
        if want != "force" or window is not None:
            raise ValueError("a pair list serves force-only calls on a whole layout")
        pair_list.check(spec, dev)
    if potential not in _POTENTIAL_ID:
        raise NotImplementedError(_NO_KERNEL)
    if mode not in ("none", "shift", "xplor"):
        raise ValueError(f"unknown shift mode {mode!r}")
    T = tables.shape[-1]
    check_tensor(tables, "tables", torch.float32,
                 (_N_LEAD + len(KERNEL_POTENTIALS[potential]), T, T), dev)

    lib = _library()
    force = torch.empty((S, 3), dtype=torch.float32, device=dev)
    want_all = want == "all"
    energy = torch.empty((S,), dtype=torch.float32, device=dev) if want_all else None
    virial = torch.empty((S, 6), dtype=torch.float32, device=dev) if want_all else None
    # launched with the tensors' device current (a shard may lie on another card)
    with torch.cuda.device(dev):
        err = lib.az_cell_pair_force(
            src.position.data_ptr(), src.typeid.data_ptr(), src.tag.data_ptr(),
            tables.data_ptr(), T, *spec.dims, spec.cap, *geom, *box_args(src),
            int(not spec.newton_ok), _POTENTIAL_ID[potential], int(mode == "xplor"), int(want_all),
            force.data_ptr(),
            energy.data_ptr() if want_all else None,
            virial.data_ptr() if want_all else None,
            *((pair_list.entries.data_ptr(), pair_list.counts.data_ptr(),
               pair_list.fallback.data_ptr(), pair_list.plans.data_ptr(), pair_list.cap_e,
               PLAN_INTS) if pair_list is not None else (None, None, None, None, 0, 0)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise launch_error(lib, "cell_pair_force", err)
    launches += 1
    launches_by_potential[potential] = launches_by_potential.get(potential, 0) + 1
    return ForceResult(force=force, energy=energy, virial=virial)


def build_pair_list(dense: State, ref_position: torch.Tensor, spec: GridSpec, r_max: float,
                    pair_list: PairList) -> None:
    """Launch K1's list build on the current stream (no synchronisation):
    each lane of ``pair_list`` lists its candidates within
    :func:`list_rsq` of ``r_max`` at ``ref_position`` (the layout's last
    rebuild, ``GridMeta.ref_position``), in the order the force's sweep
    visits them; ``dense`` gives the layout (tags) and the box."""
    global list_builds
    dev = check_cell_args("build_pair_list", dense, spec, "force", spec.S)
    check_tensor(ref_position, "ref_position", torch.float32, (spec.S, 3), dev)
    pair_list.check(spec, dev)
    cols = spec.dims[0] * spec.dims[1]
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.az_cell_pair_list(
            ref_position.data_ptr(), dense.typeid.data_ptr(), dense.tag.data_ptr(), 1,
            *spec.dims, spec.cap, 0, cols, 0, cols, *box_args(dense), int(not spec.newton_ok),
            list_rsq(r_max, spec.buffer, dense.box), pair_list.entries.data_ptr(),
            pair_list.counts.data_ptr(), pair_list.fallback.data_ptr(),
            pair_list.plans.data_ptr(), pair_list.n_fallback.data_ptr(), pair_list.cap_e,
            PLAN_INTS, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise launch_error(lib, "build_pair_list", err)
    list_builds += 1


def pair_force(energy_force_fn, dense: State, spec: GridSpec, tbl: dict,
               mode: str = "none", want: str = "all", window: Window | None = None,
               pair_list: PairList | None = None) -> ForceResult:
    """Pair force of one potential on the dense grid, by the tensors' device.

    ``tbl`` holds the device tables of :class:`azplugins_tpu_torch.md.pair.Pair`:
    ``params``, ``r_cut``, ``r_on`` and, on CUDA, the stacked ``kernel``
    tables. CPU tensors take the plain version; CUDA tensors take the
    kernel, and a potential the kernel does not cover raises. With a
    ``window`` (a shard's), the force of its own slots, read from
    ``window.state``. A ``pair_list`` (CUDA, force only) is swept as
    :func:`cell_pair_force` sweeps it.
    """
    src = dense if window is None else window.state
    dev = src.position.device
    if dev.type == "cpu":
        jb = make_jblocks(src, spec, half=spec.newton_ok, window=window)
        return dense_pair_force(
            energy_force_fn, src, jb, spec, tbl["params"], tbl["r_cut"], tbl["r_on"],
            mode, want, window=window,
        )
    if dev.type != "cuda":
        raise ValueError(f"no pair force for device {dev}")
    name = _NAME_OF_EVALUATOR.get(energy_force_fn)
    if name is None:
        raise NotImplementedError(_NO_KERNEL)
    if "kernel" not in tbl:
        raise ValueError("CUDA pair force needs tbl['kernel'] from kernel_tables()")
    return cell_pair_force(dense, spec, tbl["kernel"], name, mode, want, window=window,
                           pair_list=pair_list)

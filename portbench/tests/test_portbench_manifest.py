"""BENCHMARK.json against the benchmark's rules, and every file it names
found by name."""

import json
import re
import sys

import pytest

from portbench import harness, manifest, port

from ._small import SHELVED, SOLVENT, run

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer")


def problems(bench: dict, root=manifest.ROOT) -> list[str]:
    """What in ``bench`` breaks the benchmark's rules; empty when sound."""
    bad = []
    if tuple(bench) != TOP_KEYS:
        bad.append(f"top-level keys {list(bench)} are not {list(TOP_KEYS)}")
    paths = bench.get("paths", [])
    if not 1 <= len(paths) <= 16:
        bad.append("1 to 16 paths")
    for p in paths:
        if not re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) or p.startswith("/") or ".." in p:
            bad.append(f"path {p!r}")
    cmd = bench.get("command", [])
    if not 1 <= len(cmd) <= 32 or any(not 1 <= len(w) <= 200 or "\n" in w for w in cmd):
        bad.append("command")
    if not isinstance(bench.get("run_seconds"), int) or not 1 <= bench["run_seconds"] <= 51:
        bad.append("run_seconds")

    def line(text, what):
        if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            bad.append(f"{what}: 1 to 200 characters on one line")

    def name(n, what):
        if not isinstance(n, str) or not NAME.match(n):
            bad.append(f"{what} {n!r}: not a name")

    configs = bench.get("configs", [])
    for c in configs:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')}: keys {sorted(c)}")
        name(c.get("name"), "config")
        line(c.get("source"), f"config {c.get('name')} source")
        line(c.get("why"), f"config {c.get('name')} why")
        if not any(c.get("file", "").startswith(p + "/") for p in paths):
            bad.append(f"config {c.get('name')}: file outside paths")
        elif not (root / c["file"]).is_file():
            bad.append(f"config {c.get('name')}: {c['file']} missing")
        if len(c.get("reduced", [])) > 16:
            bad.append(f"config {c.get('name')}: more than 16 reduced keys")
        for k in c.get("reduced", []):
            name(k, "reduced key")
    names = [c.get("name") for c in configs]
    if len(set(names)) != len(names) or not 1 <= len(names) <= 24:
        bad.append("configuration names: 1 to 24, unique")
    cells = bench.get("workloads", [])
    cell_names = [w.get("name") for w in cells]
    if len(set(cell_names)) != len(cell_names) or not 1 <= len(cells) <= 24:
        bad.append("workload names: 1 to 24, unique")
    pairs = set()
    for w in cells:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')}: keys {sorted(w)}")
        name(w.get("name"), "workload")
        name(w.get("traffic"), "traffic")
        line(w.get("why"), f"workload {w.get('name')} why")
        if w.get("config") not in names:
            bad.append(f"workload {w.get('name')}: unknown config")
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w.get('name')}: chips")
        if (w.get("config"), w.get("traffic")) in pairs:
            bad.append(f"workload {w.get('name')}: config and traffic pair repeated")
        pairs.add((w.get("config"), w.get("traffic")))
    used = {w.get("config") for w in cells}
    if set(names) - used:
        bad.append(f"configurations used by no cell: {sorted(set(names) - used)}")
    e2e = bench.get("end_to_end", [])
    layer = bench.get("per_layer", [])
    metric_names = [m.get("name") for m in e2e + layer]
    if len(set(metric_names)) != len(metric_names):
        bad.append("metric names repeat")
    if not 1 <= len(e2e) <= 16 or not 1 <= len(layer) <= 128:
        bad.append("1 to 16 end-to-end and 1 to 128 per-layer metrics")
    for m in e2e + layer:
        name(m.get("name"), "metric")
        if not UNIT.match(str(m.get("unit"))):
            bad.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            bad.append(f"metric {m.get('name')}: better")
        for c in m.get("workloads", []):
            if c not in cell_names:
                bad.append(f"metric {m.get('name')}: unknown workload {c}")
    for m in e2e:
        extra = set(m) - {"name", "unit", "better", "bound", "source", "workloads"}
        if extra or m.get("source") not in SOURCES_E2E:
            bad.append(f"end-to-end {m.get('name')}: keys or source")
        b = m.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            bad.append(f"end-to-end {m.get('name')}: bound {b}")
    if "setup_s" not in {m.get("name") for m in e2e}:
        bad.append("no setup_s")
    e2e_names = {m.get("name") for m in e2e}
    for m in layer:
        extra = set(m) - {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if extra or m.get("source") not in SOURCES:
            bad.append(f"per-layer {m.get('name')}: keys or source")
        line(m.get("layer"), f"per-layer {m.get('name')} layer")
        if m.get("moves") not in e2e_names:
            bad.append(f"per-layer {m.get('name')}: moves {m.get('moves')!r}")
            continue
        for c in m.get("workloads", cell_names):
            if m["moves"] not in {e["name"] for e in manifest.end_to_end_of(bench, c)}:
                bad.append(f"per-layer {m.get('name')}: {c} does not report {m['moves']}")
    for c in cell_names:
        reported = {m["name"] for m in manifest.end_to_end_of(bench, c)}
        if "setup_s" not in reported or len(reported) < 2:
            bad.append(f"workload {c}: reports setup_s and another end-to-end metric")
        if not manifest.per_layer_of(bench, c):
            bad.append(f"workload {c}: no per-layer metric")
    if len(json.dumps(bench)) > 64 * 1024:
        bad.append("larger than 64 KiB")
    return bad


def test_benchmark_json_breaks_no_rule():
    assert problems(BENCH) == []


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", "", "x" * 65, "é"])
def test_names_refuse_spaces_commas_slashes_and_other_letters(bad):
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["name"] = bad
    assert problems(bench)


@pytest.mark.parametrize("unit", ["steps per second", "µs", "", "x" * 17])
def test_units_refuse_spaces_and_other_letters(unit):
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"][0]["unit"] = unit
    assert problems(bench)


def test_a_metric_moving_what_its_cells_do_not_report_is_refused():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["moves"] = "tps_nowhere"
    assert problems(bench)
    bench = json.loads(json.dumps(BENCH))
    bench["end_to_end"][0]["workloads"] = []
    assert problems(bench)


def test_every_moves_is_reported_by_each_of_its_cells():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert m["moves"] in {e["name"] for e in manifest.end_to_end_of(BENCH, cell)}


def finds_its_files(bench: dict, cell: str) -> dict:
    """``cell`` of ``bench`` finds each of its files by name, its limits are
    its family's (each a number the family reports, or
    ``replay_shortfall``, which each cell has), and a small CPU run of it
    judges every number it reports (else :class:`harness.Unjudged`);
    returns that run's result."""
    w = manifest.workload(bench, cell)
    params = manifest.config_params(bench, w["config"])
    builder = manifest.config_builder(w["config"])
    for attr in ("SOURCE", "ASSUMED", "REDUCED", "initial_state", "build", "model"):
        assert hasattr(builder, attr)
    assert builder.SOURCE == manifest.config_entry(bench, w["config"])["source"]
    assert builder.REDUCED == manifest.config_entry(bench, w["config"])["reduced"]
    assert params["types"]
    traffic = manifest.traffic(w["traffic"])
    for key in ("n_particles", "run_steps", "warmup_calls", "check_steps", "trace_at"):
        assert key in traffic
    limits = manifest.limits(cell)
    family = manifest.reference(w)
    for attr in ("NUMBERS", "CONTROL", "STRETCH_READS", "snapshot", "read_state", "Judge",
                 "fires", "stretch_work"):
        assert hasattr(family, attr)
    assert harness.SHORTFALL in limits
    assert set(limits) <= {*family.NUMBERS, harness.SHORTFALL}
    for m in manifest.per_layer_of(bench, cell):
        assert callable(manifest.metric_reader(m["name"]))
    for m in manifest.end_to_end_of(bench, cell):
        assert m["name"] == "setup_s" or manifest.end_to_end_reader(m["name"])(
            {"steps": 3000, "seconds": 1.5, "setup_s": 9.0}) == 2000.0
    result = run(cell, bench=bench)
    assert set(result["checked"]) - {harness.SHORTFALL}
    return result


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    finds_its_files(BENCH, cell)


def test_a_cell_of_another_family_finds_its_files_by_name(files):
    """A solvent cell (``_small.SOLVENT``, its family ``solvent`` in
    ``tests/families/``) needs limits only for its own family's numbers."""
    result = finds_its_files(SOLVENT, "idle_srd.stream2k")
    assert list(result["checked"]) == ["solvent_position_gap", "replay_shortfall"]


def test_a_metric_without_a_file_of_its_own_is_read_by_its_base_name():
    code = manifest.metric_reader("device_idle_pct.logged").__code__
    assert code.co_filename == manifest.metric_reader("device_idle_pct").__code__.co_filename
    assert manifest.end_to_end_reader("tps.droplet")({"steps": 10, "seconds": 2.0}) == 5.0
    assert manifest.end_to_end_reader("setup_s")({"setup_s": 12.5}) == 12.5
    with pytest.raises(FileNotFoundError):
        manifest.metric_reader("no_such_metric.logged")


@pytest.mark.parametrize("cell", sorted(SHELVED))
def test_the_cells_left_out_keep_their_files(cell):
    assert cell not in {w["name"] for w in BENCH["workloads"]}
    w = SHELVED[cell]
    assert manifest.config_entry(BENCH, w["config"])
    assert manifest.traffic(w["traffic"])["n_particles"] == 64000
    assert manifest.limits(cell)["replay_shortfall"] == 0


@pytest.mark.parametrize("kernel", ["pair", "integrator", "peaks"])
def test_roofline_files_are_found_by_name(kernel):
    assert manifest.roofline(kernel) is not None


@pytest.mark.parametrize("loaded, found", [
    ("azplugins_tpu_torch.ops.dense", []),
    ("azplugins_tpu_torch", []),
    ("azplugins_tpu", ["azplugins_tpu"]),
    ("azplugins_tpu.ops", ["azplugins_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]),
    ("flax.linen", ["flax"]),
    ("jaxtyping", []),
])
def test_forbidden_modules_compare_whole_top_level_names(loaded, found):
    assert harness.forbidden_modules(["torch", "numpy", loaded]) == found


def test_the_harness_and_the_port_load_no_jax():
    harness.FORBIDDEN  # noqa: B018 - the harness is imported
    before = set(sys.modules)
    import torch

    port.load(torch.device("cpu"))
    loaded = {m.split(".")[0] for m in set(sys.modules) - before}
    assert not loaded & set(harness.FORBIDDEN)

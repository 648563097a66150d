"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one kernel's roofline is a file of its own:

- ``portbench/configs/<config>.json``: the configuration as it is run, and
  ``portbench/configs/<config>.py``: its builder (``SOURCE``, ``ASSUMED``,
  ``REDUCED``, ``build``, ``model``);
- ``portbench/traffic/<traffic>.json``: a traffic mix's parameters;
- ``portbench/end_to_end/<metric>.py``: an end-to-end metric's reader,
  ``read(window)``, from the window's steps, seconds and set-up;
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx)``, returning a number or None;

a metric ``<name>.<part>`` without a file of its own is read by the file
of ``<name>`` (``device_idle_pct.droplet`` by ``device_idle_pct.py``): the
same quantity in cells that report another end-to-end metric;
- ``portbench/roofline/<kernel>.py``: a kernel's operations and bytes;
- ``portbench/limits/<cell>.json``: the limit of each number that decides
  a cell's ``correct``;
- ``portbench/reference/<family>.py``: a physics family, the plain
  reference that judges a configuration's runs, named by its builder's
  ``REFERENCE`` (``md`` where it names none).

A later change adds a cell, a configuration or a metric by adding files and
entries, never by editing one of these.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _module(path: Path, name: str):
    """A file of the benchmark, loaded as a module by its path (names may
    hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_params(bench: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / config_entry(bench, name)["file"]) as fh:
        return json.load(fh)


def config_builder(name: str):
    return _module(HERE / "configs" / f"{name}.py", f"portbench_config_{name}")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def limits(cell: str) -> dict:
    with open(HERE / "limits" / f"{cell}.json") as fh:
        return json.load(fh)


def _reader(folder: str, name: str):
    """``read`` of ``<folder>/<name>.py``, or of the file named by the part
    of ``name`` before its first dot where ``name`` has no file."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        path = HERE / folder / f"{name.split('.')[0]}.py"
    return _module(path, f"portbench_{folder}_{path.stem}").read


def metric_reader(name: str):
    return _reader("metrics", name)


def end_to_end_reader(name: str):
    return _reader("end_to_end", name)


def roofline(kernel: str):
    return _module(HERE / "roofline" / f"{kernel}.py", f"portbench_roofline_{kernel}")


def reference(cell: dict):
    """The physics family that judges ``cell``: ``reference/<family>.py``,
    the family that its configuration's builder names by ``REFERENCE``
    (``md`` where it names none). Loaded once a process under the
    package's name, so that a family's classes stay one."""
    family = getattr(config_builder(cell["config"]), "REFERENCE", "md")
    path = HERE / "reference" / f"{family}.py"
    name = f"portbench.reference.{family}"
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    return _module(path, name)


def end_to_end_of(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose moved metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_of(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out

"""Smoke-run every example of the port end to end on the CPU.

Each ``azplugins_tpu_torch/examples/*.py`` is executed with
``AZTPU_EXAMPLE_FAST=1`` (tiny system, short run), ``main(device="cpu")``
and a temporary working directory, as tests/test_examples.py runs the JAX
package's copies. The examples carry their own checks (the FENE bonds
stay below R0, the MPCD flow develops, the colloids ride it). The
trajectory ``lj_fluid`` writes reads back in the reference's
``TrajectoryReader`` as the port wrote it.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from azplugins_tpu_torch.examples import EXAMPLES  # noqa: E402

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent.parent / "azplugins_tpu_torch" / "examples"


def _run(name, monkeypatch, tmp_path):
    monkeypatch.setenv("AZTPU_EXAMPLE_FAST", "1")
    monkeypatch.chdir(tmp_path)  # trajectory/output files land here
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)  # reads FAST
        assert mod.FAST
        mod.main(device="cpu")
    finally:
        sys.modules.pop(spec.name, None)


def test_the_nine_examples_are_listed():
    assert sorted(EXAMPLES) == sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")
    reference = pathlib.Path(__file__).resolve().parent.parent / "examples"
    assert sorted(EXAMPLES) == sorted(p.stem for p in reference.glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke(name, monkeypatch, tmp_path, capsys):
    _run(name, monkeypatch, tmp_path)
    out = capsys.readouterr().out
    assert out.strip(), f"{name} produced no output"
    assert "nan" not in out.lower(), out
    if name == "lj_fluid":
        from azplugins_tpu.io import TrajectoryReader as RefReader

        from azplugins_tpu_torch.io import TrajectoryReader

        with RefReader(str(tmp_path / "lj_fluid.azt")) as r, \
                TrajectoryReader(str(tmp_path / "lj_fluid.azt")) as p:
            assert r.timesteps == p.timesteps == [200, 400]
            for i in range(len(r)):
                (rt, rf), (pt, pf) = r.read_frame(i), p.read_frame(i)
                assert rt == pt and set(rf) == set(pf)
                for k in rf:
                    np.testing.assert_array_equal(rf[k], pf[k])
            _, first = r.read_frame(0)
            assert first["particles/position"].shape == (216, 3)
            assert np.isfinite(first["particles/position"]).all()

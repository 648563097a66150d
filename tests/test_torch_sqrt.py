"""The port's square root: correctly rounded on the CPU, and the only one
its modules call.

PyTorch's CPU ``torch.sqrt`` on float32 is 1 ulp off on some hosts (a
vectorised kernel), while the reference's ``jnp.sqrt`` and numpy's
``np.sqrt`` are correctly rounded everywhere. ``azplugins_tpu_torch.utils.sqrt``
takes the root in float64 on a CPU float32 tensor; every module of the port
goes through it.
"""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import torch

from azplugins_tpu_torch.utils import sqrt

_PORT = pathlib.Path(__file__).resolve().parent.parent / "azplugins_tpu_torch"

_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 1.0, 2.0, 4.0,
                      np.finfo(np.float32).max, np.finfo(np.float32).tiny,
                      np.finfo(np.float32).smallest_subnormal, 1e-45, 3e-39],
                     dtype=np.float32)


def _float32_cases(seed=20, n=1 << 20):
    """n float32 values from their bit patterns (every exponent, subnormals
    and negatives included), uniform ones in [0, 10), and the special
    values."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    uniform = rng.uniform(0.0, 10.0, size=n).astype(np.float32)
    subnormal = rng.integers(1, 1 << 23, size=4096, dtype=np.uint32).view(np.float32)
    return np.concatenate([words.view(np.float32), uniform, subnormal, _SPECIALS])


def test_sqrt_is_bitwise_numpy_on_cpu_float32():
    x = _float32_cases()
    assert x.size >= 10**6
    got = sqrt(torch.from_numpy(x)).numpy()
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    assert got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    # the sign of zero survives: sqrt(-0) = -0
    assert np.signbit(sqrt(torch.tensor([-0.0])).numpy()[0])


def test_sqrt_leaves_other_dtypes_to_torch():
    x64 = torch.from_numpy(np.random.default_rng(3).uniform(0, 9, 1000))
    assert torch.equal(sqrt(x64), torch.sqrt(x64))
    assert sqrt(torch.ones(3, dtype=torch.float16)).dtype == torch.float16
    assert sqrt(torch.ones(2, 3)).shape == (2, 3)


def _sqrt_uses(tree):
    """(line, text) of every attribute named sqrt, sqrt_ or rsqrt(_) that is
    not numpy's or math's (``np.sqrt``, ``math.sqrt``)."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr in ("sqrt", "sqrt_", "rsqrt", "rsqrt_")
                and not (isinstance(node.value, ast.Name)
                         and node.value.id in ("np", "numpy", "math"))):
            yield node.lineno, ast.unparse(node)


def test_port_takes_its_square_roots_through_the_helper():
    helper = _PORT / "utils" / "__init__.py"
    found = []
    for path in sorted(_PORT.rglob("*.py")):
        uses = list(_sqrt_uses(ast.parse(path.read_text(), filename=str(path))))
        if path == helper:
            # the helper itself: torch.sqrt, once for each branch
            assert [u for _, u in uses] == ["torch.sqrt", "torch.sqrt"], uses
            continue
        found += [f"{path.relative_to(_PORT.parent)}:{line}: {use}" for line, use in uses]
    assert not found, "call azplugins_tpu_torch.utils.sqrt instead:\n" + "\n".join(found)


def test_source_check_sees_a_direct_call():
    src = "import torch\nimport numpy as np\ny = torch.sqrt(x) + x.sqrt() + np.sqrt(2.0)\n"
    assert sorted(u for _, u in _sqrt_uses(ast.parse(src))) == ["torch.sqrt", "x.sqrt"]

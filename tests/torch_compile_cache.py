"""JAX's persistent compilation cache, held off for one test.

``tests/conftest.py`` points JAX's persistent compilation cache at one
directory that every process of a parallel run (``pytest -n``) reads and
writes. The reference's runs on its 8-device CPU mesh, made while other
processes compile into that cache, can abort their process (``Fatal Python
error: Aborted`` in ``Simulation.run``'s read of the mesh's flag); the same
runs with the cache off do not. A test that runs the reference on that
mesh takes :func:`no_compile_cache`: the cache is off for the test (and the
cache JAX has opened dropped, since JAX decides once whether it uses one),
then on again as it was, so every other test keeps it. Import the fixture
into the test module and name it in ``pytest.mark.usefixtures``.
"""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache


@pytest.fixture
def no_compile_cache():
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)
        compilation_cache.reset_cache()

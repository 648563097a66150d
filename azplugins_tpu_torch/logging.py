"""Loggable-quantity categories (hoomd.logging parity layer).

The reference exposes observables through ``@hoomd.logging.log`` with a
category and tests the contract with ``hoomd.conftest.logging_check``
(reference ``src/compute.py:87-91``,
``src/pytest/test_compute.py:105-115``). This module provides
the same surface for the engine (a verbatim port of
``azplugins_tpu/logging.py``):

  * ``log(category=..., requires_run=...)`` — property decorator that
    registers the quantity's metadata on the class;
  * ``LoggerCategories`` — the category names;
  * ``loggables(cls_or_obj)`` — the registered quantities of a class
    (walks the MRO, so subclasses inherit their base's loggables);
  * ``logging_check(cls, expected)`` — test helper asserting the contract.

``write.Logger`` consumes this registry: ``logger.add(obj)`` with no
explicit quantity list logs every default-on loggable of the object.
"""

from __future__ import annotations

import enum

__all__ = ["LoggerCategories", "log", "loggables", "logging_check"]


class LoggerCategories(enum.Flag):
    """Categories of loggable quantities (hoomd.logging.LoggerCategories)."""

    scalar = enum.auto()  # a single float/int
    sequence = enum.auto()  # a 1D array of numbers
    string = enum.auto()
    particle = enum.auto()  # a per-particle array
    object = enum.auto()  # anything else


class _LoggableProperty(property):
    """A property carrying loggable metadata."""

    _loggable_meta: dict


def log(category: str | LoggerCategories = "scalar", *, requires_run: bool = False,
        default: bool = True):
    """Decorator: expose a method as a loggable property with a category.

    Mirrors ``hoomd.logging.log``. ``requires_run`` marks quantities that
    are undefined before the first ``sim.run`` (they raise until then).
    """
    if isinstance(category, str):
        category = LoggerCategories[category]

    def wrap(fn):
        prop = _LoggableProperty(fn)
        prop._loggable_meta = {
            "name": fn.__name__,
            "category": category,
            "requires_run": bool(requires_run),
            "default": bool(default),
        }
        return prop

    return wrap


def loggables(cls_or_obj) -> dict:
    """All loggable quantities of a class/instance: name -> metadata."""
    cls = cls_or_obj if isinstance(cls_or_obj, type) else type(cls_or_obj)
    out: dict[str, dict] = {}
    for klass in reversed(cls.__mro__):
        for name, attr in vars(klass).items():
            meta = getattr(attr, "_loggable_meta", None)
            if meta is not None:
                out[name] = meta
    return out


def logging_check(cls, expected: dict):
    """Assert the loggable contract of ``cls`` (hoomd.conftest parity).

    ``expected`` maps quantity name -> {"category": LoggerCategories,
    "default": bool}. Every expected quantity must be registered with the
    right category/default flag.
    """
    actual = loggables(cls)
    for name, spec in expected.items():
        assert name in actual, f"{cls.__name__} has no loggable {name!r}"
        meta = actual[name]
        assert meta["category"] == spec["category"], (
            f"{cls.__name__}.{name}: category {meta['category']} != "
            f"{spec['category']}"
        )
        if "default" in spec:
            assert meta["default"] == spec["default"], (
                f"{cls.__name__}.{name}: default {meta['default']} != "
                f"{spec['default']}"
            )

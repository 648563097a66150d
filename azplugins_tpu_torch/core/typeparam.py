"""Validated per-type / per-type-pair parameters.

Equivalent of HOOMD's ``TypeParameterDict``/``ParameterDict``
layer used throughout the reference Python API
(reference ``src/pair.py:116``, ``bond.py:61``, ``external.py:63``). Parameters
are set by type *name* (single names or unordered pairs), validated and
defaulted eagerly, and compiled at attach time into dense ``[T]`` or
``[T, T]`` device tables the jitted kernels index by typeid.
"""

from __future__ import annotations

from collections.abc import MutableMapping

import numpy as np

__all__ = ["TypeParameter", "require", "OPTIONAL"]


class _Required:
    def __repr__(self):
        return "<required>"


REQUIRED = _Required()
OPTIONAL = object()


def require(typ):
    """Mark a parameter key as required with the given python type."""
    return (typ, REQUIRED)


def _normalize_key(key, len_keys):
    if len_keys == 1:
        if not isinstance(key, str):
            raise KeyError(f"expected a type name string, got {key!r}")
        return key
    if not (isinstance(key, tuple) and len(key) == len_keys):
        raise KeyError(f"expected a tuple of {len_keys} type names, got {key!r}")
    return tuple(sorted(key))


class TypeParameter(MutableMapping):
    """Mapping of type name (or unordered type-name tuple) to parameter dicts.

    Args:
        name: parameter name (for error messages).
        len_keys: 1 for per-type, 2 for per-type-pair.
        spec: mapping key -> (python type, default) where default may be
            ``REQUIRED``. A bare type means required; a bare value means
            optional with that default. ``spec=None`` means the value itself
            is a scalar (e.g. ``r_cut``) validated by ``scalar_type``.
        scalar_type: type of scalar values when ``spec is None``.
    """

    def __init__(self, name, len_keys, spec=None, scalar_type=float, default=None):
        self.name = name
        self.len_keys = len_keys
        self.scalar_type = scalar_type
        self._default = default
        self._data = {}
        self._spec = None
        if spec is not None:
            norm = {}
            for k, v in spec.items():
                if isinstance(v, tuple) and len(v) == 2 and v[1] is REQUIRED:
                    norm[k] = (v[0], REQUIRED)
                elif isinstance(v, type):
                    norm[k] = (v, REQUIRED)
                else:
                    norm[k] = (type(v), v)
            self._spec = norm

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key):
        key = _normalize_key(key, self.len_keys)
        if key not in self._data and self._spec is not None:
            # hoomd-style auto-create: default-filled entry (required keys
            # become None placeholders validated at attach/table-build time);
            # the returned dict is live, so entry.update(...) writes back.
            entry = {}
            for pkey, (_ptype, default) in self._spec.items():
                entry[pkey] = None if default is REQUIRED else default
            self._data[key] = entry
        return self._data[key]

    def __setitem__(self, key, value):
        key = _normalize_key(key, self.len_keys)
        self._data[key] = self._validate(key, value)

    def __delitem__(self, key):
        del self._data[_normalize_key(key, self.len_keys)]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    # -- validation ----------------------------------------------------------
    def _validate(self, key, value):
        if self._spec is None:
            try:
                return self.scalar_type(value)
            except (TypeError, ValueError) as e:
                raise TypeError(
                    f"{self.name}[{key}]: expected {self.scalar_type.__name__}, got {value!r}"
                ) from e
        if not isinstance(value, dict):
            raise TypeError(f"{self.name}[{key}]: expected a dict, got {value!r}")
        out = {}
        for pkey, (ptype, default) in self._spec.items():
            if pkey in value:
                v = value[pkey]
                if ptype is float:
                    v = float(v)
                elif ptype is int:
                    v = int(v)
                elif ptype is bool:
                    v = bool(v)
                out[pkey] = v
            elif default is REQUIRED:
                raise KeyError(f"{self.name}[{key}]: missing required key '{pkey}'")
            else:
                out[pkey] = default
        unknown = set(value) - set(self._spec)
        if unknown:
            raise KeyError(f"{self.name}[{key}]: unknown keys {sorted(unknown)}")
        return out

    # -- compilation to dense tables -----------------------------------------
    def _lookup(self, key):
        if key in self._data:
            entry = self._data[key]
            if isinstance(entry, dict):
                missing = [k for k, v in entry.items() if v is None]
                if missing:
                    raise KeyError(
                        f"{self.name}[{key}]: required keys {missing} were never set"
                    )
                entry = self._validate(key, entry)
            return entry
        if self._default is not None:
            return self._default
        raise KeyError(
            f"{self.name}: no value set for {key!r} and no default available"
        )

    def to_scalar_table(self, types: list[str], dtype=np.float32) -> np.ndarray:
        """Dense table of scalar values: shape [T] or [T, T]."""
        T = len(types)
        if self.len_keys == 1:
            out = np.zeros((T,), dtype=dtype)
            for i, ti in enumerate(types):
                out[i] = self._lookup(ti)
            return out
        out = np.zeros((T, T), dtype=dtype)
        for i, ti in enumerate(types):
            for j, tj in enumerate(types):
                v = self._lookup(_normalize_key((ti, tj), 2))
                out[i, j] = v
        return out

    def to_dict_tables(self, types: list[str]) -> dict[str, np.ndarray]:
        """Dense tables per spec key: each shape [T] or [T, T] (float64 host)."""
        T = len(types)
        keys = list(self._spec.keys())
        tables = {}
        for pkey in keys:
            if self.len_keys == 1:
                arr = np.zeros((T,), dtype=np.float64)
                for i, ti in enumerate(types):
                    arr[i] = self._lookup(ti)[pkey]
            else:
                arr = np.zeros((T, T), dtype=np.float64)
                for i, ti in enumerate(types):
                    for j, tj in enumerate(types):
                        arr[i, j] = self._lookup(_normalize_key((ti, tj), 2))[pkey]
            tables[pkey] = arr
        return tables

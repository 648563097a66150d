"""The plain reference: PyTorch operations in float64 (a lower precision for
the control), independent of the program; it imports nothing of it.

Each physics family is a module of its own here, ``<family>.py`` (``md``:
``md.py`` with ``physics.py``), found by the name a configuration's builder
gives as ``REFERENCE`` (``manifest.reference``); ``threefry.py`` and
``outputs.py`` are shared."""

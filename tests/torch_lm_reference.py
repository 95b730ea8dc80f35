"""The JAX package's LM and serving modules, as references for the port's tests.

``repro/models/lm.py`` registers a vmap rule at import (lm.py:232) with
``optimization_barrier_p not in jax.interpreters.batching.primitive_batchers``.
Under jax 0.9 that object is a ``PrimitiveBatchersProxy`` with no
``__contains__``, so the import raises ``TypeError`` (ROADMAP Queue 3, R1).
:func:`load` imports the modules with a stand-in whose ``__contains__``
looks in ``jax._src.interpreters.batching.fancy_primitive_batchers`` and
whose ``__setitem__`` forwards to the real proxy, then puts the proxy back.
jax 0.9 already has that rule, so nothing is registered.

It then leaves ``sys.modules`` as it found it: every module the import
added is removed again, and so is every attribute it set on an
already-imported ``repro`` package.  The JAX package's own tests that import
``repro.models.lm`` in a test body therefore fail or pass exactly as they
do without these tests, whichever pytest worker runs them.  This module is
a test helper, not a test file; nothing in ``src/repro`` is changed.
"""
from __future__ import annotations

import importlib
import os
import sys
import types

from jax._src.interpreters import batching as _batching_impl
from jax.interpreters import batching as _batching

MODULES = ("repro.models.lm", "repro.serving.engine", "repro.serving.loadgen",
           "repro.serving.scheduler", "repro.serving.surrogate_engine",
           "repro.launch.dryrun", "repro.launch.mesh")

_loaded = None


class _BatchersStandIn:
    def __init__(self, real):
        self._real = real

    def __contains__(self, prim) -> bool:
        return prim in _batching_impl.fancy_primitive_batchers

    def __setitem__(self, prim, rule) -> None:
        self._real[prim] = rule


def _repro_modules() -> dict:
    return {name: mod for name, mod in sys.modules.items()
            if name == "repro" or name.startswith("repro.")}


def load() -> types.SimpleNamespace:
    """``lm``, ``engine``, ``loadgen``, ``scheduler``, ``surrogate_engine``,
    ``dryrun`` and ``mesh`` of the JAX package, imported once per process;
    ``sys.modules`` is left as it was, and so is ``XLA_FLAGS``, which
    ``repro/launch/dryrun.py`` sets at import (jax has its devices by then,
    so the flag would only reach processes started later)."""
    global _loaded
    if _loaded is not None:
        return _loaded
    before = set(sys.modules)
    flags = os.environ.get("XLA_FLAGS")
    attrs = {name: set(vars(mod)) for name, mod in _repro_modules().items()}
    real = _batching.primitive_batchers
    _batching.primitive_batchers = _BatchersStandIn(real)
    try:
        mods = [importlib.import_module(name) for name in MODULES]
    finally:
        _batching.primitive_batchers = real
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
        for name in set(sys.modules) - before:
            del sys.modules[name]
        for name, mod in _repro_modules().items():
            for attr in set(vars(mod)) - attrs.get(name, set()):
                delattr(mod, attr)
    _loaded = types.SimpleNamespace(lm=mods[0], engine=mods[1], loadgen=mods[2],
                                    scheduler=mods[3], surrogate_engine=mods[4],
                                    dryrun=mods[5], mesh=mods[6])
    return _loaded

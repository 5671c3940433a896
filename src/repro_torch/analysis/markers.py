"""Hot-path markers the analyzer keys on.

``@hot_path`` declares a function part of the steady-state serving hot
path: the decode tick, wave gather/scatter, spec draft/verify rounds.
Rule R1 (``repro-lint``) then rejects any host-sync construct inside it
— ``.item()``, ``np.asarray`` on device values, ``float()``/``int()``
on device scalars, ``jax.device_get`` — unless the site carries a
``# repro-lint: ok(R1, <reason>)`` marker.  The decorator is a pure
annotation (sets ``__hot_path__`` and returns the function unchanged),
so it composes with ``jax.jit``/``jax.vmap`` and costs nothing at
runtime; it exists so the static pass and human readers agree on where
the hot path IS.

Functions that cannot carry a decorator (e.g. generated code) can be
named in ``HOT_PATH_MODULES`` instead: a mapping of module-path suffix
(POSIX, e.g. ``"core/scheduler.py"``) to the set of function names the
analyzer must treat as hot in that module.
"""
from __future__ import annotations

from typing import Callable, Dict, FrozenSet, TypeVar

F = TypeVar("F", bound=Callable)


def hot_path(fn: F) -> F:
    """Mark ``fn`` as steady-state hot-path code (see module docstring)."""
    fn.__hot_path__ = True
    return fn


# module-path suffix -> function names that are hot even without the
# decorator (reserved for functions the decorator cannot reach)
HOT_PATH_MODULES: Dict[str, FrozenSet[str]] = {}

"""Names a package offers without importing them (PEP 562).

A package that must stay cheap to import (the serving worker binds its
socket before anything loads torch) maps each public name to the
submodule that defines it and resolves the name on first use.
"""

import importlib
import sys


def lazy_getattr(package: str, exports: dict):
    """The module ``__getattr__`` of ``package``: ``exports`` maps a
    public name to the submodule (relative to ``package``) that defines
    it, or to ``None`` when the name is the submodule itself. A resolved
    name is cached in the package's namespace."""

    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        mod = exports[name]
        if mod is None:
            value = importlib.import_module(f"{package}.{name}")
        else:
            value = getattr(importlib.import_module(f"{package}.{mod}"),
                            name)
        setattr(sys.modules[package], name, value)
        return value

    return __getattr__

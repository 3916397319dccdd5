"""Keep a package importable under a former name.

``alias_package(old, new)`` makes ``import old`` and ``import old.x.y``
return the very module objects of ``new`` and ``new.x.y`` — one copy of
every class, registry and jitted function, whichever name imported it —
and warns once that the name is deprecated.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys
import warnings


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``old.<sub>`` to the already-importable ``new.<sub>``."""

    def __init__(self, old: str, new: str):
        self.old, self.new = old, new

    def find_spec(self, name, path=None, target=None):
        if name.startswith(self.old + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(self.new + spec.name[len(self.old):])

    def exec_module(self, module):
        pass  # the module is the new package's, already executed


def alias_package(old: str, new: str) -> None:
    warnings.warn(f"the package `{old}` was renamed `{new}`: import `{new}`",
                  DeprecationWarning, stacklevel=3)
    if not any(isinstance(f, _AliasFinder) and f.old == old
               for f in sys.meta_path):
        # first in line: the path finder would otherwise load a second
        # copy of every submodule under the old name
        sys.meta_path.insert(0, _AliasFinder(old, new))
    sys.modules[old] = importlib.import_module(new)

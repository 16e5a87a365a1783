"""Deprecated alias of :mod:`custrings`, the package's former name.

Importing it warns once and yields the very module objects of
``custrings``: the alias package itself, and every module below it
(``<alias>.nvstrings is custrings.nvstrings``), so code written against
the former name keeps working and shares one set of caches.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import custrings

warnings.warn(
    f"{__name__} is deprecated; import custrings instead",
    DeprecationWarning,
    stacklevel=2,
)


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<alias>.x.y` to the already-importable `custrings.x.y`."""

    def __init__(self, alias: str):
        self.alias = alias
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if name.startswith(self.alias + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(
            "custrings" + spec.name[len(self.alias):]
        )
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # the real module already ran; importlib stamped the alias spec
        # on it, so give it back its own
        module.__spec__ = self._specs.pop(module.__name__)


sys.meta_path.insert(0, _AliasFinder(__name__))
sys.modules[__name__] = custrings

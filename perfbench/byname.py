"""The benchmark's modules found by name, as harness.reader finds a metric's
reader: ``perfbench/<directory>/<name>.py``.

- ``schemes/<scheme>``: a scheme's key material and its plain gate
  bootstrap (the reference's side, plain PyTorch);
- ``drive/<scheme>``: the same scheme on the program's side;
- ``circuits/<circuit>``: a circuit's operands, its plaintext result and
  its reference over a scheme's gates;
- ``kinds/<kind>``: a kind of traffic mix.

A configuration's ``scheme``, a traffic file's ``kind`` and ``circuit``
name these files, so a cell that needs a new one adds a file and changes
none. A name is letters, digits and ``_`` (it may begin with a digit:
``3gen``).
"""

from __future__ import annotations

import importlib
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_]+\Z")


class ByName:
    """The modules of ``perfbench/<directory>/``: ``name in it``,
    ``it[name]`` (the module, imported once) and iteration over the names."""

    def __init__(self, directory: str, what: str):
        self.directory, self.what = directory, what

    def _path(self, name: str) -> str:
        return os.path.join(HERE, self.directory, f"{name}.py")

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and bool(NAME.match(name)) and os.path.isfile(self._path(name))

    def __getitem__(self, name: str):
        if name not in self:
            raise KeyError(f"no {self.what} named {name!r}: perfbench/{self.directory}/{name}.py "
                           "is not there")
        return importlib.import_module(f"{__package__}.{self.directory}.{name}")

    def __iter__(self):
        files = os.listdir(os.path.join(HERE, self.directory))
        return iter(sorted(f[:-3] for f in files if f.endswith(".py") and not f.startswith("_")
                           and f[:-3] in self))

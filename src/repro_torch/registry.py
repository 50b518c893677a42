"""Tiny name -> entry registries with actionable unknown-name errors.

The port's copy of ``repro.registry``.  Used by the dataset registry
(``repro_torch.data.registry.DATASETS``).

The contract: looking up an unregistered name raises ``ValueError``
whose message lists every registered option, so a typo'd name fails
with the fix in the traceback.
"""
from __future__ import annotations


class Registry:
    """Ordered name -> entry mapping.

    ``register`` refuses silent shadowing unless ``overwrite=True``;
    ``get`` on an unknown name raises ValueError naming the registered
    options (the actionable-error contract the api layer rides on).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict = {}

    def register(self, name: str, entry, overwrite: bool = False):
        if not isinstance(name, str) or not name:
            raise ValueError(f"{self.kind} name must be a non-empty "
                             f"string, got {name!r}")
        if name in self._entries and not overwrite:
            raise ValueError(
                f"{self.kind} {name!r} is already registered; pass "
                f"overwrite=True to replace it")
        self._entries[name] = entry
        return entry

    def get(self, name: str):
        try:
            return self._entries[name]
        except (KeyError, TypeError):
            opts = ", ".join(repr(n) for n in self.names()) or "<none>"
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered "
                f"{self.kind}s: {opts}") from None

    def __contains__(self, name) -> bool:
        try:
            return name in self._entries
        except TypeError:
            return False

    def names(self) -> list:
        return sorted(self._entries)

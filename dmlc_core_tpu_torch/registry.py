"""Name → factory registry.

A copy of ``dmlc_core_tpu/registry.py`` in the port. Equivalent of
reference ``include/dmlc/registry.h`` (310 L):
``Registry<EntryType>::Get/Find/__REGISTER__`` (registry.h:48-78) and
``FunctionRegEntryBase`` with describe/add_argument metadata
(registry.h:150-226). The static-link rescue macros
(DMLC_REGISTRY_FILE_TAG/LINK_TAG, registry.h:234-308) have no Python
counterpart — module import *is* registration.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Generic, List, Optional, Tuple, TypeVar

from dmlc_core_tpu_torch.base import DMLCError

__all__ = ["Registry", "RegistryEntry"]

T = TypeVar("T")


class RegistryEntry(Generic[T]):
    """Factory entry — reference ``FunctionRegEntryBase`` (registry.h:150)."""

    def __init__(self, name: str, factory: Callable[..., T]):
        self.name = name
        self.factory = factory
        self.description = ""
        self.arguments: List[Tuple[str, str, str]] = []  # (name, type, desc)
        self.return_type = ""

    def describe(self, description: str) -> "RegistryEntry[T]":
        """Set the entry's human-readable description; returns self for
        chaining."""
        self.description = description
        return self

    def add_argument(self, name: str, type_str: str, desc: str
                     ) -> "RegistryEntry[T]":
        """Document one accepted argument (name, type, description)."""
        self.arguments.append((name, type_str, desc))
        return self

    def set_return_type(self, t: str) -> "RegistryEntry[T]":
        """Record the factory's return type name; returns self for chaining."""
        self.return_type = t
        return self

    def __call__(self, *args: Any, **kwargs: Any) -> T:
        return self.factory(*args, **kwargs)


class Registry(Generic[T]):
    """Singleton-per-name registries — reference ``Registry<E>`` (registry.h:48).

    Usage::

        parsers = Registry.get("data_parser")

        @parsers.register("libsvm")
        def make_libsvm(source, args): ...

        entry = parsers.find("libsvm")
    """

    _registries: Dict[str, "Registry"] = {}

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, RegistryEntry[T]] = {}

    @classmethod
    def get(cls, kind: str) -> "Registry":
        """The process-wide registry for `kind`, created on first use
        (reference Registry<T>::Get singleton)."""
        reg = cls._registries.get(kind)
        if reg is None:
            reg = cls._registries[kind] = Registry(kind)
        return reg

    def register(self, name: str, factory: Optional[Callable[..., T]] = None,
                 override: bool = False):
        """Register a factory; usable directly or as a decorator
        (reference ``__REGISTER__``, registry.h:78)."""
        def do_register(fn: Callable[..., T]) -> RegistryEntry[T]:
            if name in self._entries and not override:
                raise DMLCError(
                    f"{self.kind} registry: {name!r} already registered")
            entry = RegistryEntry(name, fn)
            self._entries[name] = entry
            return entry
        if factory is not None:
            return do_register(factory)
        return do_register

    def find(self, name: str) -> Optional[RegistryEntry[T]]:
        """Reference ``Registry::Find`` (registry.h:48-56) — None if absent."""
        return self._entries.get(name)

    def lookup(self, name: str) -> RegistryEntry[T]:
        """Entry by name; raises DMLCError listing known entries when
        absent (use find() for the None-returning probe)."""
        entry = self.find(name)
        if entry is None:
            raise DMLCError(
                f"{self.kind} registry: unknown entry {name!r}; known: "
                f"{sorted(self._entries)}")
        return entry

    def list_names(self) -> List[str]:
        """Registered entry names, sorted (reference ListAllNames)."""
        return sorted(self._entries)

    def remove(self, name: str) -> None:
        """Unregister an entry by name (no-op when absent)."""
        self._entries.pop(name, None)

"""Shared name->entry registry: one surface for every pluggable family.

A copy of ``repro.core.registry`` (the port imports nothing of the JAX
package); the error texts are identical so either package's callers and
tests read the same messages. Schedulers (``repro_torch.core.schedulers``)
and update backends (``repro_torch.kernels.ops``) are addressable by string
spec so that ``BPConfig`` stays JSON-serializable end-to-end and a config
serialized by either package loads in the other:

- keys are canonical **lowercase** names (the serialized form),
- missing names raise the **uniform error format**
  ``KeyError("unknown <kind> <name>; registered: [...]")`` so callers and
  tests can rely on one message shape across families,
- duplicate registration raises ``ValueError`` (silent overwrite hid typos
  and shadowed built-ins; pass ``overwrite=True`` to replace deliberately),
- ``names()`` is the sorted listing behind the ``list_schedulers()`` /
  ``list_backends()`` module functions.

``Registry`` subclasses ``dict``, so the module-level names (``SCHEDULERS``,
``UPDATE_BACKENDS``) behave as plain dicts -- ``in``, ``sorted(...)``,
indexing, ``.items()``, ``.pop()`` -- with the uniform
``lookup``/``add``/``register``/``names`` surface on top.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, TypeVar

T = TypeVar("T")

__all__ = ["Registry"]


class Registry(Dict[str, T]):
    """A named ``dict`` of string spec -> registered entry (class/factory).

    ``kind`` names the family ("scheduler", "update backend", ...) and is
    interpolated into the uniform ``KeyError`` every registry raises for
    unknown names: ``unknown <kind> <name>; registered: [...]``. Keys are
    lowercased on the way in (``add``/``register``) and on the way out
    (``lookup``), so the canonical serialized form is always lowercase.
    """

    def __init__(self, kind: str,
                 initial: Mapping[str, T] | Iterable = ()) -> None:
        super().__init__({str(k).lower(): v
                          for k, v in dict(initial).items()})
        self.kind = kind

    def lookup(self, name: str) -> T:
        """Resolve ``name`` (case-insensitive) to its registered entry.

        Raises the family's uniform error for unknown names:
        ``KeyError("unknown <kind> <name>; registered: [...]")``.
        """
        try:
            return self[str(name).lower()]
        except KeyError:
            raise KeyError(self.unknown(name)) from None

    def unknown(self, name) -> str:
        """The uniform unknown-name message for this family (also used by
        callers that reject a *known but unsupported* name subset, e.g. the
        banded runner, so every error reads the same)."""
        return f"unknown {self.kind} {name!r}; registered: {self.names()}"

    def names(self) -> List[str]:
        """Sorted registered names -- the ``list_*()`` implementation."""
        return sorted(self)

    def add(self, name: str, entry: T, *, overwrite: bool = False) -> T:
        """Register ``entry`` under ``name`` (lowercased); returns it.

        Duplicate names raise ``ValueError`` unless ``overwrite=True`` --
        a silent overwrite would shadow a built-in behind the same spec
        string every serialized config resolves through.
        """
        key = str(name).lower()
        if not overwrite and key in self:
            raise ValueError(
                f"duplicate {self.kind} {name!r}: already registered "
                f"(pass overwrite=True to replace)")
        self[key] = entry
        return entry

    def register(self, name: str, *,
                 overwrite: bool = False) -> Callable[[T], T]:
        """Decorator form of :meth:`add`:

            @REGISTRY.register("mine")
            class Mine: ...
        """
        def deco(entry: T) -> T:
            return self.add(name, entry, overwrite=overwrite)
        return deco

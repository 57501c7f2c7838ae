"""Typed engine options: the solve API's single options surface.

    solve_batch(trees, loads, k, options=EngineOptions(cap=False))
    solve_forest(f, k, options=EngineOptions(device="cpu"))

Unknown fields fail in the ``EngineOptions`` constructor; stray keyword
arguments to the solve entry points fail in :func:`resolve_options` with a
did-you-mean hint. The JAX package's ``use_pallas`` and ``interpret`` do
not exist here: a CUDA tensor always goes through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Options consumed by ``solve_forest`` / ``solve_batch``.

    dtype:        DP table dtype (float32 default; float64 for exactness on
                  arbitrary rates)
    device:       where the solve runs, "cuda" by default; "cpu" runs the
                  kernels' plain torch versions
    cap:          min(k, subtree) per-level budget-width truncation
    color:        False = costs-only mode (no traceback, no masks)
    debug_tables: full-table pullback + host-numpy color
    """

    dtype: Any = torch.float32
    device: str = "cuda"
    cap: bool = True
    color: bool = True
    debug_tables: bool = False

    def replace(self, **changes) -> "EngineOptions":
        """A copy with ``changes`` applied (validated like the ctor)."""
        return dataclasses.replace(self, **changes)


_FIELDS = tuple(f.name for f in dataclasses.fields(EngineOptions))

_REMOVED = (
    "engine options are not accepted as keyword arguments ({names}); "
    "pass options=EngineOptions({example}) instead"
)


def resolve_options(options: EngineOptions | None,
                    engine_kw: dict,
                    where: str) -> EngineOptions:
    """Validate the ``options=`` spelling at the call boundary.

    * ``options`` alone -> returned as-is (defaults when None);
    * any stray keyword argument -> ``TypeError`` here: a misspelled or
      unknown option gets a did-you-mean hint, a known field name gets the
      ``options=EngineOptions(...)`` spelling;
    * both at once -> ``TypeError`` (ambiguous precedence is never guessed).
    """
    if not engine_kw:
        if options is None:
            return EngineOptions()
        if not isinstance(options, EngineOptions):
            raise TypeError(f"{where}: options must be an EngineOptions, "
                            f"got {type(options).__name__}")
        return options
    if options is not None:
        raise TypeError(
            f"{where}: got both options= and engine keyword arguments "
            f"{sorted(engine_kw)}; pass everything through "
            "options=EngineOptions(...)")
    unknown = [k for k in engine_kw if k not in _FIELDS]
    if unknown:
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, _FIELDS, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                     if close else ""))
        raise TypeError(
            f"{where}: unknown engine option(s) {', '.join(hints)}; "
            f"valid options: {', '.join(_FIELDS)}")
    raise TypeError(f"{where}: " + _REMOVED.format(
        names=", ".join(sorted(engine_kw)),
        example=", ".join(f"{k}=..." for k in sorted(engine_kw))))

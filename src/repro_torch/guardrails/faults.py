"""Numerical fault injection over the runtime format table
(``repro.guardrails.faults``).

A fault is a *table transform*: the hot-swap train step and
``truncate_sweep`` route every policy decision through a ``(num_sites, 4)``
int32 row table that is an argument of the step, so corrupting a site --
swapping its row to a catastrophically narrow rung, forcing
overflow-to-inf, or arming the quantizer's bit-flip channel -- is a table
*value* change: no new enumeration. The injected state is what a bad policy
deployment or a corrupted registry row would produce at run time.

Three fault kinds:

  * ``"overflow"`` -- swap the site's row to :data:`OVERFLOW_ROW` (1
    exponent bit, IEEE overflow): any value above ~1.5 becomes inf.
  * ``"swap_row"`` -- swap to an arbitrary narrow rung (``row=`` a format
    spec or a (4,) row), e.g. ``"e2m1"`` for catastrophic rounding.
  * ``"bitflip"`` -- arm the quantizer's fault channel
    (:func:`bitflip_row`): ``quantize_dynamic`` (on the card, the
    ``quantize_em_dynamic`` kernel) XORs the chosen carrier bit into every
    element the site emits. Bit 30 (the f32 top exponent bit) models a
    silent data corruption that scales values by ~2^64.

The tables are numpy arrays, as in the reference; a step copies one to the
device when it changes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.kernels.quantize_em.ops import format_row

# catastrophically narrow rung: one exponent bit leaves max_finite at 1.0,
# and non-saturating IEEE semantics send anything larger straight to inf
# (while anything below ~0.5 flushes to zero)
OVERFLOW_ROW = np.array([1, 1, 0, 1], np.int32)

F32_SIGN_BIT = 31
F32_TOP_EXP_BIT = 30


def overflow_row() -> np.ndarray:
    """The (4,) row that forces overflow-to-inf for O(1)-scale data."""
    return OVERFLOW_ROW.copy()


def bitflip_row(base_row, bit: int) -> np.ndarray:
    """Arm the bit-flip fault channel on ``base_row``: pack ``bit`` into the
    high bits of the ieee_inf field (``field3 = ieee_inf | (bit+1) << 1``,
    decoded and stripped by the dynamic quantizer). The format the site
    quantizes to is unchanged -- only the post-quantize XOR is armed."""
    if not 0 <= bit <= 62:
        raise ValueError(f"bit index must be in [0, 62], got {bit}")
    row = np.asarray(base_row, np.int32).copy()
    row[3] = (row[3] & 1) | ((bit + 1) << 1)
    return row


def clean_row(row) -> np.ndarray:
    """Strip any armed fault channel from a row (the inverse of
    :func:`bitflip_row`)."""
    row = np.asarray(row, np.int32).copy()
    row[3] &= 1
    return row


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: corrupt table row ``site`` at ``step``."""

    site: int
    step: int
    kind: str = "overflow"          # "overflow" | "bitflip" | "swap_row"
    bit: int = F32_TOP_EXP_BIT      # for "bitflip"
    row: Optional[Tuple[int, ...]] = None   # for "swap_row": format spec/row

    def fault_row(self, current_row) -> np.ndarray:
        if self.kind == "overflow":
            return overflow_row()
        if self.kind == "bitflip":
            return bitflip_row(current_row, self.bit)
        if self.kind == "swap_row":
            if self.row is None:
                raise ValueError("swap_row fault needs row=")
            if isinstance(self.row, str):
                return format_row(self.row)
            return np.asarray(self.row, np.int32)
        raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """Scheduled corruption of a live format table.

    Each spec fires once, at the first applied step >= its trigger step,
    and the corrupted row then *persists* -- a deployment whose policy goes
    bad mid-run -- until something (the guardrail controller) rewrites it.
    ``apply`` never mutates its input table."""

    def __init__(self, faults: Sequence[FaultSpec] = ()):
        self.faults = list(faults)
        self._fired: set = set()

    def __len__(self) -> int:
        return len(self.faults)

    def pending(self) -> List[FaultSpec]:
        return [f for i, f in enumerate(self.faults) if i not in self._fired]

    def apply(self, table, step: int) -> Tuple[np.ndarray, List[FaultSpec]]:
        """Returns ``(table', fired)`` -- the (possibly new) table and the
        specs that fired at this step."""
        out = None
        fired: List[FaultSpec] = []
        for i, f in enumerate(self.faults):
            if i in self._fired or step < f.step:
                continue
            if out is None:
                out = np.array(table, np.int32, copy=True)
            if not 0 <= f.site < len(out):
                raise IndexError(
                    f"fault site {f.site} out of range for "
                    f"{len(out)}-site table")
            out[f.site] = f.fault_row(out[f.site])
            self._fired.add(i)
            fired.append(f)
        return (np.asarray(table, np.int32) if out is None else out), fired

    def reset(self) -> None:
        self._fired.clear()


def sites_for_scope(site_index, scope: str) -> List[int]:
    """Table rows of ``site_index`` whose normalized scope equals ``scope``
    or nests under it -- maps a trajectory-blame scope to its rows."""
    return [s.index for s in site_index.sites
            if s.scope == scope or s.scope.startswith(scope + "/")]


__all__ = ["FaultSpec", "FaultPlan", "overflow_row", "bitflip_row",
           "clean_row", "sites_for_scope", "OVERFLOW_ROW",
           "F32_SIGN_BIT", "F32_TOP_EXP_BIT"]

"""MiningPlan dispatch spine.

Every batched counting entry resolves a :class:`MiningPlan` — a frozen
description of one counting launch: its *capacity-class bucket* (episode
level, table width, batch rows, each rounded up to a power of two by
:func:`capacity_class`) plus the engine, tile/chunk config and scheduler
flavor — pads its inputs to the bucket (+inf table columns, repeated
candidate rows: both inert) and calls :func:`dispatch`, which runs the
registered builder's function on them. Shapes entering dispatch are
therefore bucket fixed points, so a per-bucket cache (CUDA graphs, a later
step of the port) can key on the plan alone. There is no executable cache
here: PyTorch runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = [
    "MiningPlan", "plan_for", "dispatch", "register_fn", "resolve_tiles",
    "pow2_ceil", "capacity_class", "pad_rows", "pad_width",
]

#: the port's tile defaults (block_next, block_prev, window_tiles, chunk);
#: the reference's tuned table was tuned for another machine and is not read
DEFAULT_TILES = (256, 256, 0, 8)


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 0) — THE bucketing round."""
    return 1 << max(0, int(x) - 1).bit_length() if x > 0 else 1


def capacity_class(n: int, floor: int = 1) -> int:
    """Capacity class for a size: pow2_ceil with a lower bound (``floor``
    itself a power of two, so every class stays a pow2 bucket)."""
    return max(int(floor), pow2_ceil(n))


@dataclass(frozen=True)
class MiningPlan:
    """Hashable static-shape bucket + resolved launch config. Shape fields
    are already rounded to capacity classes; tile fields are integers."""

    fn: str                  # registered counting function name
    level: int               # episode length N (symbols per candidate row)
    n_types: int             # alphabet size
    cap: int                 # per-type table width, class-rounded
    batch: int               # candidate rows, class-rounded
    streams: int = 0         # corpus stream rows, class-rounded (0 = none)
    engine: str = "dense"
    parallel_schedule: bool = False
    block_next: int = 256
    block_prev: int = 256
    window_tiles: int = 0
    chunk: int = 8


def resolve_tiles(
    *,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
    chunk: Optional[int] = None,
) -> Tuple[int, int, int, int]:
    """(block_next, block_prev, window_tiles, chunk): explicit integers win
    field by field, ``None`` takes the port's default."""
    given = (block_next, block_prev, window_tiles, chunk)
    return tuple(d if g is None else int(g)
                 for g, d in zip(given, DEFAULT_TILES))


def plan_for(
    fn: str,
    *,
    level: int,
    n_types: int,
    cap: int,
    batch: int,
    streams: int = 0,
    engine: str = "dense",
    parallel_schedule: bool = False,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
) -> MiningPlan:
    """Resolve a :class:`MiningPlan`: round shapes to capacity classes and
    resolve the tiles."""
    bn, bp, wt, ch = resolve_tiles(block_next=block_next,
                                   block_prev=block_prev,
                                   window_tiles=window_tiles)
    return MiningPlan(
        fn=fn, level=int(level), n_types=int(n_types),
        cap=capacity_class(cap), batch=pow2_ceil(batch),
        streams=pow2_ceil(streams) if streams else 0, engine=engine,
        parallel_schedule=bool(parallel_schedule), block_next=bn,
        block_prev=bp, window_tiles=wt, chunk=ch)


def pad_rows(arr: torch.Tensor, target: int) -> torch.Tensor:
    """Pad the leading axis to ``target`` rows by repeating row 0 (the
    candidate-pad convention: counted, then discarded)."""
    b = arr.shape[0]
    if b == target:
        return arr
    reps = arr[:1].expand((target - b,) + tuple(arr.shape[1:]))
    return torch.cat([arr, reps], dim=0)


def pad_width(arr: torch.Tensor, target: int, fill) -> torch.Tensor:
    """Pad the LAST axis to ``target`` with ``fill`` (+inf for time tables
    — inert under every downstream max/searchsorted)."""
    w = arr.shape[-1]
    if w == target:
        return arr
    pad = arr.new_full(tuple(arr.shape[:-1]) + (target - w,), fill)
    return torch.cat([arr, pad], dim=-1)


_FNS: Dict[str, Callable[[MiningPlan], Callable]] = {}


def register_fn(name: str, build: Callable[[MiningPlan], Callable]) -> None:
    """Register a counting function: ``build(plan)`` returns the callable,
    with the plan's static config closed over."""
    _FNS[name] = build


def dispatch(plan: MiningPlan, *args):
    """Run a registered counting function on inputs already padded to the
    plan bucket."""
    if plan.fn not in _FNS:
        from . import counting  # noqa: F401 — importing registers builders
    if plan.fn not in _FNS:
        raise KeyError(f"no counting function registered as {plan.fn!r}")
    return _FNS[plan.fn](plan)(*args)

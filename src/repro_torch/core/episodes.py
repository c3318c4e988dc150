"""Serial episodes with inter-event time constraints (paper §II-C, Def. 2).

An N-node serial episode ``A -(l1,h1]-> B -(l2,h2]-> C ...`` pairs N event
types with N-1 half-open inter-event windows: a valid occurrence satisfies
``l_i < t_{i+1} - t_i <= h_i`` for every consecutive pair.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Episode:
    symbols: Tuple[int, ...]           # event-type ids, length N >= 1
    t_low: Tuple[float, ...] = ()      # length N-1, each >= 0
    t_high: Tuple[float, ...] = ()     # length N-1, each > t_low

    def __post_init__(self):
        object.__setattr__(self, "symbols", tuple(int(s) for s in self.symbols))
        object.__setattr__(self, "t_low", tuple(float(x) for x in self.t_low))
        object.__setattr__(self, "t_high", tuple(float(x) for x in self.t_high))
        n = len(self.symbols)
        if n < 1:
            raise ValueError("episode needs >= 1 symbol")
        if len(self.t_low) != n - 1 or len(self.t_high) != n - 1:
            raise ValueError("need N-1 inter-event constraints")
        for lo, hi in zip(self.t_low, self.t_high):
            if lo < 0:
                raise ValueError("t_low must be >= 0 (windows are (low, high])")
            if hi <= lo:
                raise ValueError("t_high must exceed t_low")

    @property
    def n(self) -> int:
        return len(self.symbols)

    def as_arrays(self, device="cuda"):
        """``(symbols i32[N], t_low f32[N-1], t_high f32[N-1])`` on
        ``device`` (the card unless the caller asks for the CPU). The
        windows are cast to float32: every engine compares in float32."""
        device = resolve_device(device)
        return (
            torch.tensor(self.symbols, dtype=torch.int32, device=device),
            torch.tensor(self.t_low, dtype=torch.float32, device=device),
            torch.tensor(self.t_high, dtype=torch.float32, device=device),
        )

    def __str__(self):
        parts = [str(self.symbols[0])]
        for s, lo, hi in zip(self.symbols[1:], self.t_low, self.t_high):
            parts.append(f"-({lo:g},{hi:g}]->{s}")
        return "".join(parts)


def serial(symbols: Sequence[int], low: float, high: float) -> Episode:
    """Episode with one shared (low, high] window for every gap."""
    n = len(symbols)
    return Episode(tuple(symbols), (low,) * (n - 1), (high,) * (n - 1))


def episodes_from_rows(rows, t_low: float, t_high: float) -> "list[Episode]":
    """Inverse of :func:`episode_batch` for uniform windows.

    ``rows`` is i32[B, N] symbol rows (the miner's array form); every gap
    gets the shared (t_low, t_high] window. N == 1 rows get no windows.
    """
    rows = np.asarray(rows, np.int64)
    if rows.ndim != 2:
        raise ValueError("rows must be [B, N]")
    n = rows.shape[1]
    lo, hi = (t_low,) * (n - 1), (t_high,) * (n - 1)
    return [Episode(tuple(int(s) for s in row), lo, hi) for row in rows]


def episode_batch(episodes: Sequence[Episode], device="cuda"):
    """Pack same-length episodes into dense tensors for batched counting,
    on ``device`` (the card unless the caller asks for the CPU).

    Returns (symbols [B,N] i32, t_low [B,N-1] f32, t_high [B,N-1] f32).
    """
    device = resolve_device(device)
    ns = {e.n for e in episodes}
    if len(ns) != 1:
        raise ValueError("episode_batch requires equal-length episodes")
    sym = np.asarray([e.symbols for e in episodes], np.int32)
    lo = np.asarray([e.t_low for e in episodes], np.float32).reshape(len(episodes), -1)
    hi = np.asarray([e.t_high for e in episodes], np.float32).reshape(len(episodes), -1)
    return (torch.as_tensor(sym, device=device),
            torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))

"""Event streams (paper §II-C, Definition 1) and the per-type index.

An event stream is a time-sorted sequence of (event_type, time) pairs. The
paper's pre-processing step (noting the positions of the events of each
type, §IV-A) becomes a padded dense ``[n_types, cap]`` table of per-type
event times, so every later step works on fixed shapes.

Padding convention (used consistently across core/ and kernels/):
  * padded *times* are ``+inf`` (so searchsorted keeps them at the tail),
  * padded *values* (latest-start bookkeeping) are ``-inf``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

INF = float("inf")


def _as_tensor(x, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dtype)


@dataclasses.dataclass
class EventStream:
    """A finite, time-ordered event sequence.

    Attributes:
      types: int32[n]  event-type ids in ``[0, n_types)``.
      times: float32[n] non-decreasing occurrence times.
      n_types: size of the event-type alphabet (``|xi|``).

    Arrays given as numpy (or lists) become CPU tensors; tensors keep
    their device. The miner moves the stream to its own device.
    """

    types: torch.Tensor
    times: torch.Tensor
    n_types: int

    def __post_init__(self):
        self.types = _as_tensor(self.types, torch.int32)
        self.times = _as_tensor(self.times, torch.float32)
        if self.types.ndim != 1 or self.times.ndim != 1:
            raise ValueError("types/times must be rank-1")
        if self.types.shape[0] != self.times.shape[0]:
            raise ValueError("types/times length mismatch")

    @property
    def n_events(self) -> int:
        return int(self.types.shape[0])

    def validate(self) -> None:
        """Host-side sanity checks."""
        t = self.times.cpu().numpy()
        if t.size and np.any(np.diff(t) < 0):
            raise ValueError("event times must be non-decreasing")
        ty = self.types.cpu().numpy()
        if ty.size and (ty.min() < 0 or ty.max() >= self.n_types):
            raise ValueError("event types out of range")


def from_arrays(types, times, n_types: int) -> EventStream:
    s = EventStream(types, times, n_types)
    s.validate()
    return s


def type_index(
    types: torch.Tensor, times: torch.Tensor, n_types: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group event times by type into a padded dense table.

    Args:
      types: int32[n], times: float32[n] (time-sorted), on one device.
      n_types: alphabet size. cap: per-type capacity (>= 1; an explicit
        ``cap=0`` is rejected rather than read as "unset").

    Returns:
      times_by_type: float32[n_types, cap], each row the (sorted ascending)
        times of that type, padded with +inf. Events beyond ``cap`` per type
        are dropped (``counts`` reports the true totals, so overflow is
        detectable).
      counts: int32[n_types] true per-type event counts (pre-clip).

    Types outside ``[0, n_types)`` (negative ids are the padding
    convention, -1) contribute nothing. They are masked out before any
    scatter: torch's advanced indexing raises on an out-of-range index
    (a device assert on CUDA) and wraps a negative one into the last row.
    This is :func:`type_index_batch` of a one-stream corpus.
    """
    tables, counts = type_index_batch(
        _as_tensor(types, torch.int32)[None],
        _as_tensor(times, torch.float32)[None], n_types, cap)
    return tables[0], counts[0]


def type_index_batch(
    types: torch.Tensor, times: torch.Tensor, n_types: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-stream type indexes for a padded corpus, in one batched scatter.

    Args:
      types: int32[S, L] per-stream event types, ``-1`` padding (dropped,
        never scattered into a real row, as in :func:`type_index`).
      times: float32[S, L] per-stream times (time-sorted), ``+inf`` padding.

    Returns ``(tables f32[S, n_types, cap], counts i32[S, n_types])``: row
    ``s`` is :func:`type_index` of stream ``s``. Each (stream, type) pair is
    one group of a single flat ranking, so all streams are ranked and
    scattered at once.
    """
    if cap < 1:
        raise ValueError(f"type index cap must be >= 1, got {cap}")
    types = _as_tensor(types, torch.int32)
    times = _as_tensor(times, torch.float32).to(types.device)
    n_streams = types.shape[0]
    in_range = (types >= 0) & (types < n_types)
    # out-of-range types share one sentinel group per stream, past the
    # alphabet (as the reference's remap to n_types does), so real types'
    # ranks are unchanged
    grouped = torch.where(in_range, types, torch.full_like(types, n_types))
    stream = torch.arange(n_streams, dtype=torch.int32,
                          device=types.device)[:, None].expand_as(types)
    key = (stream * (n_types + 1) + grouped).reshape(-1)
    keep_in = in_range.reshape(-1)
    counts = torch.bincount(key[keep_in].long(),
                            minlength=n_streams * (n_types + 1))
    counts = counts.reshape(n_streams, n_types + 1)[:, :n_types]
    rank = _rank_within_type(key, n_streams * (n_types + 1))
    keep = keep_in & (rank < cap)
    tables = torch.full((n_streams, n_types, cap), INF, dtype=torch.float32,
                        device=types.device)
    tables[stream.reshape(-1)[keep].long(), grouped.reshape(-1)[keep].long(),
           rank[keep].long()] = times.reshape(-1)[keep]
    return tables, counts.to(torch.int32)


def _rank_within_type(types: torch.Tensor, n_types: int) -> torch.Tensor:
    """rank[i] = #events j<i with types[j]==types[i]; O(n log n)."""
    n = types.shape[0]
    order = torch.argsort(types, stable=True)            # groups types together
    sorted_types = types[order].contiguous()
    idx = torch.arange(n, dtype=torch.int32, device=types.device)
    # start index of each run of equal type within the sorted order
    starts = torch.searchsorted(sorted_types, sorted_types, side="left",
                                out_int32=True)
    rank = torch.empty(n, dtype=torch.int32, device=types.device)
    rank[order] = idx - starts
    return rank


def episode_symbol_times(
    times_by_type: torch.Tensor, counts: torch.Tensor, symbols
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather per-symbol padded time rows for one episode.

    Returns (times_by_sym [N, cap], counts_by_sym [N]).
    """
    sym = torch.as_tensor(symbols, device=times_by_type.device).long()
    return times_by_type[sym], counts[sym]

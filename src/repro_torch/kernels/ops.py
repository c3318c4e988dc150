"""Public wrappers around the tracking kernels, plus the reference's tile
math.

* :func:`track_level` / :func:`track_episode`: one tracking level for a
  batch of rows (``episode_track.track_level``), and an episode's levels
  through it;
* :func:`track_batch` / :func:`track_corpus`: every level of a candidate
  batch, or of a corpus of streams folded into the batch axis, in one
  launch (``episode_track.track_batch``);
* :func:`count_batch` / :func:`count_corpus`: tracking + compaction + the
  greedy fold in one launch (``episode_track.count_batch``).

Each kernel wrapper runs the CUDA kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor.

The tile helpers (:func:`tile_geometry`, :func:`_tile_spans`,
:func:`window_span_exceeds`, :func:`window_truncated`,
:func:`window_scan_table`, :func:`required_window_tiles`,
:func:`required_window_tiles_batch`) are the reference's window-scan
tables and bounds, kept verbatim because ``window_tiles > 0`` flags
possible window truncation through them and those flags must equal the
reference's bit for bit. The CUDA kernels do not read the tables: they
scan every window exactly, so their results do not depend on the tiles.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import episode_track as _et

NEG = float("-inf")
INF = float("inf")


# ---------------------------------------------------------------------------
# Window-span bounds and the scan table (for the truncation flag)
# ---------------------------------------------------------------------------


def _searchsorted_rows(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted(a[..., :], v[..., :], 'left')`` over shared
    leading dims."""
    return torch.searchsorted(a.contiguous(), v.contiguous(), side="left")


def _tile_spans(
    t_prev: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    t_next: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    t_high: torch.Tensor,   # f32[...] per-row window high
    block_next: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per next-tile prev-event span ``[lo_idx, hi_idx)`` + occupancy mask.

    A next tile with min ``a0`` / finite max ``a1`` needs prev events in
    ``[a0 - t_high, a1)``; rows are sorted so the tile min is element 0 and
    padding tiles (min = +inf) report ``has = False``. Returns
    ``(lo_idx, hi_idx, has)`` each shaped ``[..., next_tiles]``.
    """
    nt = t_next.shape[-1] // block_next
    tiles = t_next[..., : nt * block_next].reshape(
        tuple(t_next.shape[:-1]) + (nt, block_next))
    tile_min = tiles[..., 0]
    finite = torch.isfinite(tiles)
    tile_max = torch.where(finite, tiles, NEG).amax(dim=-1)
    has = finite[..., 0]
    t_high = torch.as_tensor(t_high, dtype=torch.float32,
                             device=t_next.device)[..., None]
    lo_idx = _searchsorted_rows(t_prev, tile_min - t_high)
    hi_idx = _searchsorted_rows(t_prev, tile_max)
    return lo_idx.to(torch.int32), hi_idx.to(torch.int32), has


def window_span_exceeds(
    lo_idx: torch.Tensor, hi_idx: torch.Tensor, cap: int,
    block_prev: int, window_tiles: int,
) -> torch.Tensor:
    """THE conservative truncation predicate (span + one tile of
    misalignment slack over the cap)."""
    span = (hi_idx - lo_idx).clamp(0, cap)
    return span // block_prev + 2 > window_tiles


def _bound_tiles(lo_idx, hi_idx, has, cap: int, block_prev: int) -> int:
    """Span in events plus one tile of misalignment slack, maxed over
    occupied next tiles (at least 1), at most every prev tile."""
    spans = torch.where(has, hi_idx - lo_idx, 0)
    need = spans // block_prev + 2
    tiles = max(1, int(need[has].max())) if bool(has.any()) else 1
    return min(tiles, cap // block_prev)


def required_window_tiles(
    t_prev, t_next, t_high: float, block_next: int, block_prev: int,
) -> int:
    """Host-side tight bound on the prev tiles any next tile's window can
    span (rows ``f32[cap]``, sorted, +inf padded)."""
    t_prev = torch.as_tensor(t_prev, dtype=torch.float32)
    t_next = torch.as_tensor(t_next, dtype=torch.float32)
    lo_idx, hi_idx, has = _tile_spans(t_prev, t_next, float(t_high),
                                      block_next)
    return _bound_tiles(lo_idx, hi_idx, has, t_prev.shape[0], block_prev)


def required_window_tiles_batch(
    times_by_sym, t_high, block_next: int, block_prev: int,
) -> int:
    """Batched :func:`required_window_tiles`: one bound covering every
    (episode, level) of a ``[B, N, cap]`` candidate batch with windows
    ``t_high f32[B, N-1]``."""
    times_by_sym = torch.as_tensor(times_by_sym, dtype=torch.float32)
    lo_idx, hi_idx, has = _tile_spans(
        times_by_sym[:, :-1], times_by_sym[:, 1:],
        torch.as_tensor(t_high, dtype=torch.float32), block_next)
    return _bound_tiles(lo_idx, hi_idx, has, times_by_sym.shape[-1],
                        block_prev)


def window_truncated(
    t_prev: torch.Tensor,   # f32[..., cap] sorted, +inf padded
    t_next: torch.Tensor,   # f32[..., cap] sorted, +inf padded
    t_high,                 # f32[...] per-row window high (or a scalar)
    block_next: int, block_prev: int, window_tiles: int,
) -> torch.Tensor:
    """Per-row truncation flag ``bool[...]``: may any next tile's
    constraint window span more than ``window_tiles`` prev tiles?"""
    cap = t_prev.shape[-1]
    lo_idx, hi_idx, _ = _tile_spans(t_prev, t_next, t_high, block_next)
    return window_span_exceeds(
        lo_idx, hi_idx, cap, block_prev, window_tiles).any(dim=-1)


def window_scan_table(
    times_by_sym: torch.Tensor,  # f32[B, N, cap] sorted rows, +inf padded
    t_high: torch.Tensor,        # f32[B, N-1]
    block_next: int,
    block_prev: int,
    window_tiles: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(episode, level, next-tile) scan table of the reference kernel.

    Returns ``(start_tile, num_tiles, truncated)``: the first prev tile and
    tile count each next tile scans (both ``i32[B, N-1, NT]``) and a
    per-episode ``bool[B]`` flag. With ``window_tiles > 0`` the scan
    lengths are capped and any episode whose conservative span bound may
    exceed the cap is flagged: capping is reported, never silent.
    """
    cap = times_by_sym.shape[-1]
    prev_tiles = cap // block_prev
    lo_idx, hi_idx, has = _tile_spans(
        times_by_sym[:, :-1], times_by_sym[:, 1:], t_high, block_next)
    start = torch.div(lo_idx, block_prev, rounding_mode="floor")
    end = torch.div(hi_idx + block_prev - 1, block_prev, rounding_mode="floor")
    num = torch.where(has, (end - start).clamp(min=0), 0)
    if 0 < window_tiles < prev_tiles:
        truncated = window_span_exceeds(
            lo_idx, hi_idx, cap, block_prev, window_tiles).any(dim=2).any(dim=1)
        num = num.clamp(max=window_tiles)
    else:
        truncated = torch.zeros(times_by_sym.shape[0], dtype=torch.bool,
                                device=times_by_sym.device)
    start = start.clamp(0, max(prev_tiles - 1, 0))
    return start.to(torch.int32), num.to(torch.int32), truncated


def tile_geometry(cap: int, block_next: int, block_prev: int) -> Tuple[int, int, int]:
    """(bn, bp, padded_cap): blocks kept as requested, capacity rounded up
    to their lcm. The reference's one tiling rule; the truncation flags
    depend on it."""
    bn = max(1, block_next)
    bp = max(1, block_prev)
    tile = math.lcm(bn, bp)
    pcap = ((cap + tile - 1) // tile) * tile
    return bn, bp, pcap


def _pad_tail(x: torch.Tensor, pcap: int, fill) -> torch.Tensor:
    cap = x.shape[-1]
    if pcap == cap:
        return x
    pad = x.new_full(tuple(x.shape[:-1]) + (pcap - cap,), fill)
    return torch.cat([x, pad], dim=-1)


def _fold(x: torch.Tensor, lead, rows: int, tail: int) -> torch.Tensor:
    """``x[*lead, *rest]`` (or broadcastable to it) as ``[rows, *rest]``
    with ``tail`` trailing dims kept."""
    x = torch.as_tensor(x, dtype=torch.float32)
    rest = tuple(x.shape[x.dim() - tail:]) if tail else ()
    return x.expand(tuple(lead) + rest).reshape((rows,) + rest).contiguous()


# ---------------------------------------------------------------------------
# One tracking level (batched rows) and an episode through it
# ---------------------------------------------------------------------------


def track_level(
    t_prev: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    v_prev: torch.Tensor,   # f32[..., cap] latest starts, -inf padded
    t_next: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    t_low,                  # f32[...] per-row window low (or a scalar)
    t_high,                 # f32[...] per-row window high (or a scalar)
    *,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """One tracking level for every row, ONE kernel launch. Leading dims
    fold into the kernel's row axis; the windows broadcast over them.
    Every window is scanned exactly, so no tile padding is needed (the
    reference's ``window_tiles`` cap is flagged by
    :func:`window_truncated`). ``chunk`` is how many rows the plain version
    takes at once on the CPU."""
    lead = tuple(t_prev.shape[:-1])
    cap = t_prev.shape[-1]
    rows = math.prod(lead)
    dev = t_prev.device
    out = _et.track_level(
        *(x.reshape(rows, cap).contiguous() for x in (t_prev, v_prev, t_next)),
        _fold(torch.as_tensor(t_low, dtype=torch.float32, device=dev),
              lead, rows, 0),
        _fold(torch.as_tensor(t_high, dtype=torch.float32, device=dev),
              lead, rows, 0),
        chunk=chunk)
    return out.reshape(lead + (cap,))


def track_episode(
    times_by_sym: torch.Tensor,   # f32[..., N, cap]
    t_low,                        # f32[..., N-1]
    t_high,                       # f32[..., N-1]
    *,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-level tracking through :func:`track_level`, one launch per
    level; returns ``(starts, ends)`` with -inf / +inf where no valid
    occurrence ends."""
    n = times_by_sym.shape[-2]
    dev = times_by_sym.device
    t_low = torch.as_tensor(t_low, dtype=torch.float32, device=dev)
    t_high = torch.as_tensor(t_high, dtype=torch.float32, device=dev)
    t0 = times_by_sym[..., 0, :]
    v = torch.where(torch.isfinite(t0), t0, NEG)
    for i in range(n - 1):
        v = track_level(times_by_sym[..., i, :], v, times_by_sym[..., i + 1, :],
                        t_low[..., i], t_high[..., i], chunk=chunk)
    ends = times_by_sym[..., n - 1, :]
    valid = (v > NEG) & torch.isfinite(ends)
    return torch.where(valid, v, NEG), torch.where(valid, ends, INF)


# ---------------------------------------------------------------------------
# Batched multi-level tracking wrappers
# ---------------------------------------------------------------------------


def track_batch(
    times_by_sym: torch.Tensor,  # f32[..., N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,         # f32[..., N-1]
    t_high: torch.Tensor,        # f32[..., N-1]
    *,
    block_next: int = 256,
    block_prev: int = 256,
    window_tiles: int = 0,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole candidate batch, all levels, ONE launch.

    Returns ``(starts f32[..., cap], n_superset i32[...],
    truncated bool[...])``. ``starts`` holds the final level's latest
    starts (-inf where no occurrence ends at that event), not masked for
    end validity: that is the engine's job. ``truncated`` is the
    reference's ``window_tiles`` flag (:func:`window_scan_table`); the
    kernel itself scans every window exactly. Stacked leading dims (a
    ``[S, B, N, cap]`` corpus) fold into the kernel's batch axis here and
    unfold on the way out; ``n == 1`` stays in PyTorch.
    """
    lead = tuple(times_by_sym.shape[:-2])
    n, cap = times_by_sym.shape[-2:]
    rows = math.prod(lead)
    dev = times_by_sym.device
    times = times_by_sym.reshape(rows, n, cap)
    if n == 1:   # no transitions: every first-symbol event is an occurrence
        t0 = times[:, 0, :]
        starts = torch.where(torch.isfinite(t0), t0, NEG)
        nsup = torch.isfinite(t0).sum(dim=-1, dtype=torch.int32)
        truncated = torch.zeros(rows, dtype=torch.bool, device=dev)
    else:
        t_low = _fold(t_low, lead, rows, 1)
        t_high = _fold(t_high, lead, rows, 1)
        bn, bp, pcap = tile_geometry(cap, block_next, block_prev)
        if 0 < window_tiles < pcap // bp:
            _, _, truncated = window_scan_table(
                _pad_tail(times, pcap, INF), t_high, bn, bp, window_tiles)
        else:   # an uncapped table never truncates
            truncated = torch.zeros(rows, dtype=torch.bool, device=dev)
        starts, nsup = _et.track_batch(times.contiguous(), t_low, t_high,
                                       chunk=chunk)
    return (starts.reshape(lead + (cap,)), nsup.reshape(lead),
            truncated.reshape(lead))


def track_corpus(
    times_by_sym: torch.Tensor,  # f32[S, B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,         # f32[B, N-1] shared across streams
    t_high: torch.Tensor,        # f32[B, N-1]
    *,
    block_next: int = 256,
    block_prev: int = 256,
    window_tiles: int = 0,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole corpus of streams x candidate batch in ONE launch: the
    windows broadcast over the stream axis, which :func:`track_batch` folds
    into the kernel's batch axis. Returns ``(starts f32[S, B, cap],
    n_superset i32[S, B], truncated bool[S, B])``."""
    return track_batch(
        times_by_sym, t_low[None], t_high[None], block_next=block_next,
        block_prev=block_prev, window_tiles=window_tiles, chunk=chunk)


# ---------------------------------------------------------------------------
# Fused single-launch count pipeline wrapper
# ---------------------------------------------------------------------------


def count_batch(
    times_by_sym: torch.Tensor,  # f32[..., N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,         # f32[..., N-1]
    t_high: torch.Tensor,        # f32[..., N-1]
    prev_end: torch.Tensor,      # f32[...] carried greedy prev_end
    prev_count: torch.Tensor,    # i32[...] carried greedy count
    *,
    block_next: int = 256,
    block_prev: int = 256,
    window_tiles: int = 0,
    chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole candidate batch, tracking + compaction + greedy, one launch.

    Returns ``(counts i32[B], end_out f32[B], n_superset i32[B],
    truncated bool[B])``. Counts include the ``prev_count`` carry-in and
    ``end_out`` is the carried greedy state. ``truncated`` is the
    reference's ``window_tiles`` flag (:func:`window_scan_table`); on a
    flagged row the reference's count is unsafe (the miner raises), while
    the kernel here still counts that row exactly. ``chunk`` is how many
    rows the plain version processes at once on the CPU.

    Stacked leading dims fold into one batch axis and unfold on the way
    out.
    """
    lead = times_by_sym.shape[:-2]
    if len(lead) > 1:
        rows = math.prod(lead)
        counts, end_out, nsup, truncated = count_batch(
            times_by_sym.reshape((rows,) + tuple(times_by_sym.shape[-2:])),
            t_low.reshape((rows,) + tuple(t_low.shape[-1:])),
            t_high.reshape((rows,) + tuple(t_high.shape[-1:])),
            prev_end.reshape(rows), prev_count.reshape(rows),
            block_next=block_next, block_prev=block_prev,
            window_tiles=window_tiles, chunk=chunk)
        return (counts.reshape(lead), end_out.reshape(lead),
                nsup.reshape(lead), truncated.reshape(lead))
    batch, n, cap = times_by_sym.shape
    dev = times_by_sym.device
    prev_end = torch.as_tensor(prev_end, dtype=torch.float32, device=dev)
    prev_count = torch.as_tensor(prev_count, dtype=torch.int32, device=dev)
    if n == 1:
        # No transitions: every first-symbol event is a [t, t] occurrence.
        # Greedy over sorted point intervals takes each finite time strictly
        # greater than both the running prev_end and its predecessor (ties
        # rejected, matching the strict `start > prev_end` rule).
        t0 = times_by_sym[:, 0, :]
        finite = torch.isfinite(t0)
        pred = torch.cat([t0.new_full((batch, 1), NEG), t0[:, :-1]], dim=1)
        take = finite & (t0 > prev_end[:, None]) & (t0 > pred)
        cnt = take.sum(dim=1, dtype=torch.int32)
        last = torch.where(take, t0, NEG).amax(dim=1)
        end_out = torch.where(cnt > 0, last, prev_end)
        nsup = finite.sum(dim=-1, dtype=torch.int32)
        return (prev_count + cnt, end_out, nsup,
                torch.zeros(batch, dtype=torch.bool, device=dev))
    bn, bp, pcap = tile_geometry(cap, block_next, block_prev)
    if 0 < window_tiles < pcap // bp:
        _, _, truncated = window_scan_table(
            _pad_tail(times_by_sym, pcap, INF), t_high, bn, bp, window_tiles)
    else:   # an uncapped table never truncates
        truncated = torch.zeros(batch, dtype=torch.bool, device=dev)
    counts, end_out, nsup = _et.count_batch(
        times_by_sym.contiguous(), t_low.to(torch.float32).contiguous(),
        t_high.to(torch.float32).contiguous(), prev_end.contiguous(),
        prev_count.contiguous(), chunk=chunk)
    return counts, end_out, nsup, truncated


def count_corpus(
    times_by_sym: torch.Tensor,  # f32[S, B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,         # f32[B, N-1] shared across streams
    t_high: torch.Tensor,        # f32[B, N-1]
    *,
    block_next: int = 256,
    block_prev: int = 256,
    window_tiles: int = 0,
    chunk: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corpus count: streams x episodes folded into ONE count launch, with
    fresh ``(-inf, 0)`` carries per row (corpus counting is stateless).
    Returns ``(counts i32[S, B], end_out f32[S, B], n_superset i32[S, B],
    truncated bool[S, B])``."""
    s, b, n = times_by_sym.shape[:3]
    dev = times_by_sym.device
    t_low = torch.as_tensor(t_low, dtype=torch.float32, device=dev)
    t_high = torch.as_tensor(t_high, dtype=torch.float32, device=dev)
    return count_batch(
        times_by_sym, t_low[None].expand(s, b, n - 1),
        t_high[None].expand(s, b, n - 1),
        torch.full((s, b), NEG, dtype=torch.float32, device=dev),
        torch.zeros((s, b), dtype=torch.int32, device=dev),
        block_next=block_next, block_prev=block_prev,
        window_tiles=window_tiles, chunk=chunk)

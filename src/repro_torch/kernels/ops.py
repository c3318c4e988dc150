"""Public wrapper around the count kernel, plus the reference's tile math.

:func:`count_batch` runs a whole ``[..., N, cap]`` candidate batch through
tracking + compaction + the greedy fold (``episode_track.count_batch``: the
CUDA kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor).

The tile helpers (:func:`tile_geometry`, :func:`_tile_spans`,
:func:`window_span_exceeds`, :func:`window_scan_table`) are the reference's
window-scan table, kept verbatim because ``window_tiles > 0`` flags
possible window truncation through it and those flags must equal the
reference's bit for bit. The CUDA kernel does not read the table: it
scans every window exactly, so its counts do not depend on the tiles.
"""
from __future__ import annotations

import math
from typing import Tuple

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

"""Parallel local tracking (paper §IV-C, Algorithm 2) — subproblem 1.

``track_dense`` — per *event* (not per occurrence path) keep only the
latest start time of any partial occurrence ending at that event. If two
occurrences end at the same event, the one with the later start is
contained in the other, so one interval per reachable end event (with the
latest start) preserves the maximum non-overlapped count, and each level
reduces to a windowed range-max: searchsorted window bounds + a sparse-table
max. Every function here takes leading batch dimensions: a batch of
episodes is a leading axis, not a ``vmap``.

Engines are exposed through a registry (:func:`register_engine`);
``counting.py`` dispatches by name. The port holds three:

  ``dense``               the plain PyTorch path above;
  ``dense_pallas``        each level one CUDA kernel launch for the whole
                          batch (``track_level``);
  ``dense_pallas_fused``  every level of a batch in one launch
                          (``track_batch``), and the single-launch count
                          pipeline: tracking, compaction and the greedy fold
                          in one CUDA kernel per candidate batch
                          (``count_batch``; kernels/episode_track.py).

All three give the same occurrences and counts bit for bit.

Padding convention: event tables are ``+inf``-padded, value (latest-start)
tables are ``-inf``-padded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Protocol, Tuple

import torch

NEG = float("-inf")
INF = float("inf")


class Occurrences(NamedTuple):
    """A padded set of candidate occurrence intervals, plus tracking stats.
    Batch-leading: ``starts/ends/valid`` are ``[..., cap]``, the stats
    ``[...]``."""

    starts: torch.Tensor      # f32[..., cap] (-inf padding)
    ends: torch.Tensor        # f32[..., cap] (+inf padding)
    valid: torch.Tensor       # bool[..., cap]
    n_superset: torch.Tensor  # i32[...] occurrences tracked (overlapping)
    overflow: torch.Tensor    # bool[...] capacity exceeded (count unsafe)


# ---------------------------------------------------------------------------
# Sparse-table range maximum
# ---------------------------------------------------------------------------


def build_sparse_table(v: torch.Tensor) -> torch.Tensor:
    """Doubling max table ``M[k, ..., i] = max(v[..., i : i+2^k])``;
    ``[K, ..., cap]`` with ``K = floor(log2(cap)) + 1``."""
    cap = v.shape[-1]
    levels = max(cap, 1).bit_length()
    table = v.new_empty((levels,) + tuple(v.shape))
    table[0] = v
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = table[k - 1]
        table[k, ..., : cap - half] = torch.maximum(
            prev[..., : cap - half], prev[..., half:])
        table[k, ..., cap - half:] = prev[..., cap - half:]   # max with -inf
    return table


def range_max(table: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Batched ``max(v[..., lo:hi])`` queries; -inf where ``hi <= lo``.
    ``lo``/``hi`` are ``[..., m]`` with the table's leading dims."""
    cap = table.shape[-1]
    rows = table[0].numel() // cap
    out_shape = lo.shape
    lo = lo.reshape(rows, -1)
    hi = hi.reshape(rows, -1)
    length = (hi - lo).clamp(0, cap)
    # floor(log2(L)) via frexp (exact for L < 2^24)
    _, exp = torch.frexp(length.clamp(min=1).to(torch.float32))
    k = (exp - 1).to(torch.int64)
    pow2 = torch.ones_like(k) << k
    # flat index of (level k, row r, column c) in the [K, rows, cap] table
    base = (k * rows + torch.arange(rows, device=table.device)[:, None]) * cap
    flat = table.reshape(-1)
    a = flat[base + lo.clamp(0, cap - 1)]
    b = flat[base + (hi - pow2).clamp(0, cap - 1)]
    return torch.where(length > 0, torch.maximum(a, b), NEG).reshape(out_shape)


# ---------------------------------------------------------------------------
# Dense tracking
# ---------------------------------------------------------------------------


def _searchsorted(sorted_rows: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted(..., side='left')``; torch wants contiguous
    rows."""
    return torch.searchsorted(sorted_rows.contiguous(), values.contiguous(),
                              side="left")


def window_max(
    t_prev: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    v_prev: torch.Tensor,   # f32[..., cap] latest starts, -inf padded
    t_next: torch.Tensor,   # f32[..., cap] sorted rows, +inf padded
    t_low: torch.Tensor,    # f32[..., 1]
    t_high: torch.Tensor,   # f32[..., 1]
) -> torch.Tensor:
    """One tracking level: per next time t, the max of ``v_prev`` over prev
    times s with ``t - hi <= s < t - lo`` (f32), -inf where the window is
    empty or t is not finite."""
    lo_idx = _searchsorted(t_prev, t_next - t_high)
    hi_idx = _searchsorted(t_prev, t_next - t_low)
    value = range_max(build_sparse_table(v_prev), lo_idx, hi_idx)
    return torch.where(torch.isfinite(t_next), value, NEG)


def track_dense(
    times_by_sym: torch.Tensor,  # f32[..., N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,         # f32[..., N-1]
    t_high: torch.Tensor,        # f32[..., N-1]
) -> Occurrences:
    n = times_by_sym.shape[-2]
    t0 = times_by_sym[..., 0, :]
    value = torch.where(torch.isfinite(t0), t0, NEG)   # latest start per event
    n_superset = torch.isfinite(t0).sum(-1, dtype=torch.int32)
    for i in range(n - 1):
        value = window_max(times_by_sym[..., i, :], value,
                           times_by_sym[..., i + 1, :], t_low[..., i:i + 1],
                           t_high[..., i:i + 1])
        n_superset = n_superset + (value > NEG).sum(-1, dtype=torch.int32)
    ends = times_by_sym[..., n - 1, :]
    valid = (value > NEG) & torch.isfinite(ends)
    return Occurrences(
        starts=value,
        ends=torch.where(valid, ends, INF),
        valid=valid,
        n_superset=n_superset,
        overflow=torch.zeros(valid.shape[:-1], dtype=torch.bool,
                             device=valid.device),
    )


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Per-call knobs threaded from the counting API down to the engines.

    ``block_next``/``block_prev``/``window_tiles`` are the tile shape of
    the reference's window scan: the port keeps them because
    ``window_tiles > 0`` flags possible truncation exactly as the reference
    does (``ops.window_scan_table``, ``ops.window_truncated``); the CUDA
    kernels themselves always scan each window exactly. ``chunk`` is how
    many rows the plain PyTorch versions of the kernels process at once on
    the CPU (it bounds their memory; the kernels ignore it). The device is
    the tensors' own.

    ``t_min`` restricts tracking to occurrences *seeded* at time >= t_min
    (windows only look backward, so this equals counting on the substream
    of events at/after ``t_min``). It is applied at the dispatch layer
    (:func:`restrict_seed_row`), so every engine honors it identically.
    """

    block_next: int = 256
    block_prev: int = 256
    window_tiles: int = 0
    chunk: int = 8
    t_min: Optional[torch.Tensor] = None


def restrict_seed_row(times_by_sym: torch.Tensor, t_min) -> torch.Tensor:
    """Drop first-symbol events before ``t_min`` from ``[..., N, cap]`` rows.

    The seed row is shifted left past its first index with time >=
    ``t_min`` and +inf-refilled, so it stays sorted. Only the seed row is
    touched: earlier events of later symbols cannot appear in any
    occurrence seeded at/after ``t_min`` anyway.
    """
    row0 = times_by_sym[..., 0, :]
    cap = row0.shape[-1]
    flat = row0.reshape(-1, cap)
    t = torch.as_tensor(t_min, dtype=torch.float32,
                        device=flat.device).reshape(1, 1).expand(flat.shape[0], 1)
    k = _searchsorted(flat, t)
    idx = k + torch.arange(cap, device=flat.device)[None, :]
    shifted = torch.gather(flat, 1, idx.clamp(max=cap - 1))
    shifted = torch.where(idx < cap, shifted, INF).reshape(row0.shape)
    return torch.cat([shifted.unsqueeze(-2), times_by_sym[..., 1:, :]], dim=-2)


def consume_seed_restriction(
    times_by_sym: torch.Tensor, cfg: EngineConfig
) -> Tuple[torch.Tensor, EngineConfig]:
    """Apply ``cfg.t_min`` to the tables and strip it from the config, so
    no engine can apply the restriction twice."""
    if cfg.t_min is None:
        return times_by_sym, cfg
    return (restrict_seed_row(times_by_sym, cfg.t_min),
            dataclasses.replace(cfg, t_min=None))


class TrackingEngine(Protocol):
    """One windowed tracking strategy.

    ``track(times_by_sym f32[..., N, cap], t_low f32[..., N-1],
    t_high f32[..., N-1], cfg) -> Occurrences`` with batch-leading outputs.

    Engines MAY also provide a native ``track_batch`` (same signature,
    preferred by :func:`track_batch_dispatch`), a native
    ``track_corpus(times_by_sym f32[S, B, N, cap], t_low f32[B, N-1],
    t_high f32[B, N-1], cfg)`` (preferred by :func:`track_corpus_dispatch`)
    and a natively-counting

        ``count_batch(times_by_sym f32[B, N, cap], t_low f32[B, N-1],
                      t_high f32[B, N-1], prev_end f32[B], prev_count i32[B],
                      cfg) -> (counts i32[B], end_out f32[B],
                               n_superset i32[B], overflow bool[B])``

    running tracking + compaction + the greedy fold in one kernel, with the
    ``(prev_end, count)`` carry in and out. ``counting.count_batch_dispatch``
    routes whole count calls through it; results are bit-for-bit those of
    the track + greedy path.
    """

    name: str

    def track(self, times_by_sym, t_low, t_high,
              cfg: EngineConfig) -> Occurrences:
        ...


_REGISTRY: Dict[str, TrackingEngine] = {}


def register_engine(engine: TrackingEngine, *,
                    overwrite: bool = False) -> TrackingEngine:
    if engine.name in _REGISTRY and not overwrite:
        raise ValueError(f"engine {engine.name!r} already registered")
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> TrackingEngine:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"engine must be one of {engine_names()}, got {name!r}") from None


def engine_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def track_batch_dispatch(
    engine,                        # str name or TrackingEngine
    times_by_sym: torch.Tensor,    # f32[B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,           # f32[B, N-1]
    t_high: torch.Tensor,          # f32[B, N-1]
    cfg: EngineConfig,
) -> Occurrences:
    """Batch-leading tracking through any engine — THE one batched
    tracking dispatch. Engines exposing a native ``track_batch`` get the
    whole batch in one call (the fused kernel); every other engine's own
    ``track`` takes the batch as a leading dimension. ``cfg.t_min`` is
    consumed here. Returns Occurrences with ``starts/ends/valid`` of shape
    ``[B, cap]`` and ``n_superset/overflow`` of shape ``[B]`` (any further
    leading dims ride along)."""
    eng = get_engine(engine) if isinstance(engine, str) else engine
    times_by_sym, cfg = consume_seed_restriction(times_by_sym, cfg)
    track_batch = getattr(eng, "track_batch", None)
    if track_batch is not None:
        return track_batch(times_by_sym, t_low, t_high, cfg)
    return eng.track(times_by_sym, t_low, t_high, cfg)


def track_corpus_dispatch(
    engine,                        # str name or TrackingEngine
    times_by_sym: torch.Tensor,    # f32[S, B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,           # f32[B, N-1] shared across streams
    t_high: torch.Tensor,          # f32[B, N-1]
    cfg: EngineConfig,
) -> Occurrences:
    """Corpus-leading tracking through any engine: one candidate batch
    against ``S`` independent streams. Engines exposing a native
    ``track_corpus`` get the whole corpus in one call (the fused engine
    folds the stream axis into its batch axis: one launch for every
    stream); for every other engine the windows broadcast over the stream
    axis and :func:`track_batch_dispatch` takes ``[S, B]`` as leading dims.
    Returns ``[S, B]``-leading Occurrences."""
    eng = get_engine(engine) if isinstance(engine, str) else engine
    times_by_sym, cfg = consume_seed_restriction(times_by_sym, cfg)
    track_corpus = getattr(eng, "track_corpus", None)
    if track_corpus is not None:
        return track_corpus(times_by_sym, t_low, t_high, cfg)
    lead = tuple(times_by_sym.shape[:2])
    return track_batch_dispatch(
        eng, times_by_sym, t_low.expand(lead + tuple(t_low.shape[-1:])),
        t_high.expand(lead + tuple(t_high.shape[-1:])), cfg)


@dataclasses.dataclass(frozen=True)
class DenseEngine:
    """Windowed range-max tracking in plain PyTorch (no compaction)."""

    name: str = "dense"

    def track(self, times_by_sym, t_low, t_high,
              cfg: EngineConfig) -> Occurrences:
        return track_dense(times_by_sym, t_low, t_high)


def _pallas_tile_geometry(cap: int, cfg: EngineConfig):
    """(bn, bp, padded_cap): the reference's engine-policy block clamp
    ([8, 256]) composed with the shared tiling rule in kernels/ops.py; the
    truncation flags depend on it tile for tile, and so both kernel
    engines' flags agree."""
    from ..kernels import ops  # deferred: the kernels import this module

    return ops.tile_geometry(
        cap, max(8, min(cfg.block_next, 256)), max(8, min(cfg.block_prev, 256)))


def _occurrences(times_by_sym, starts, n_superset, overflow) -> Occurrences:
    """Occurrences from the final level's latest starts: valid where an
    occurrence reaches a finite last-symbol event."""
    ends = times_by_sym[..., -1, :]
    valid = (starts > NEG) & torch.isfinite(ends)
    return Occurrences(starts=starts, ends=torch.where(valid, ends, INF),
                       valid=valid, n_superset=n_superset, overflow=overflow)


@dataclasses.dataclass(frozen=True)
class DensePallasEngine:
    """Dense tracking with each level ONE CUDA kernel launch for the whole
    batch (``kernels/episode_track.py::track_level``): the same windowed
    max, and so the same counts, as ``dense``.

    ``window_tiles`` keeps the reference's meaning: with ``0 <
    window_tiles < padded_cap // block_prev`` any level whose constraint
    window may span more prev tiles than that is flagged through
    ``overflow`` (the miner raises), by the same predicate as the fused
    engine. The kernel itself scans every window exactly."""

    name: str = "dense_pallas"

    def track(self, times_by_sym, t_low, t_high,
              cfg: EngineConfig) -> Occurrences:
        from ..kernels import ops  # deferred: the kernels import this module

        n, cap = times_by_sym.shape[-2:]
        bn, bp, pcap = _pallas_tile_geometry(cap, cfg)
        capped = 0 < cfg.window_tiles < pcap // bp
        t0 = times_by_sym[..., 0, :]
        v = torch.where(torch.isfinite(t0), t0, NEG)
        n_superset = torch.isfinite(t0).sum(-1, dtype=torch.int32)
        overflow = torch.zeros(t0.shape[:-1], dtype=torch.bool,
                               device=t0.device)
        for i in range(n - 1):
            t_prev = times_by_sym[..., i, :]
            t_next = times_by_sym[..., i + 1, :]
            if capped:
                overflow = overflow | ops.window_truncated(
                    ops._pad_tail(t_prev, pcap, INF),
                    ops._pad_tail(t_next, pcap, INF), t_high[..., i], bn, bp,
                    cfg.window_tiles)
            v = ops.track_level(t_prev, v, t_next, t_low[..., i],
                                t_high[..., i], chunk=cfg.chunk)
            n_superset = n_superset + (v > NEG).sum(-1, dtype=torch.int32)
        return _occurrences(times_by_sym, v, n_superset, overflow)


@dataclasses.dataclass(frozen=True)
class FusedDensePallasEngine:
    """The single-launch pipelines: every tracking level of a whole
    candidate batch in ONE CUDA kernel launch (``track_batch``), and
    tracking, the paper's §IV-D compaction and the strict greedy fold in
    ONE launch (``count_batch``; kernels/episode_track.py). Same dominance
    argument, and so the same occurrences and counts, as ``dense``.

    ``track_batch`` is the native batched entry and ``track`` the same
    function (the port's ``track`` takes leading batch dims);
    ``track_corpus`` folds the stream axis into the kernel's batch axis.
    ``window_tiles > 0`` flags possible truncation as ``dense_pallas``
    does."""

    name: str = "dense_pallas_fused"

    def track_batch(self, times_by_sym, t_low, t_high,
                    cfg: EngineConfig) -> Occurrences:
        from ..kernels import ops  # deferred: the kernels import this module

        bn, bp, _ = _pallas_tile_geometry(times_by_sym.shape[-1], cfg)
        starts, n_superset, truncated = ops.track_batch(
            times_by_sym, t_low, t_high, block_next=bn, block_prev=bp,
            window_tiles=cfg.window_tiles, chunk=cfg.chunk)
        return _occurrences(times_by_sym, starts, n_superset, truncated)

    track = track_batch

    def track_corpus(self, times_by_sym, t_low, t_high,
                     cfg: EngineConfig) -> Occurrences:
        from ..kernels import ops  # deferred: the kernels import this module

        bn, bp, _ = _pallas_tile_geometry(times_by_sym.shape[-1], cfg)
        starts, n_superset, truncated = ops.track_corpus(
            times_by_sym, t_low, t_high, block_next=bn, block_prev=bp,
            window_tiles=cfg.window_tiles, chunk=cfg.chunk)
        return _occurrences(times_by_sym, starts, n_superset, truncated)

    def count_batch(self, times_by_sym, t_low, t_high, prev_end, prev_count,
                    cfg: EngineConfig):
        """Returns ``(counts i32[B], end_out f32[B], n_superset i32[B],
        overflow bool[B])`` with the carried chain state included."""
        from ..kernels import ops  # deferred: the kernels import this module

        bn, bp, _ = _pallas_tile_geometry(times_by_sym.shape[-1], cfg)
        return ops.count_batch(
            times_by_sym, t_low, t_high, prev_end, prev_count,
            block_next=bn, block_prev=bp, window_tiles=cfg.window_tiles,
            chunk=cfg.chunk)


register_engine(DenseEngine())
register_engine(DensePallasEngine())
register_engine(FusedDensePallasEngine())

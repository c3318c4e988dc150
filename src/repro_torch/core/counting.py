"""Non-overlapped episode counting — the paper's redesigned algorithm (§IV).

Counting = parallel local tracking (subproblem 1) + greedy overlap
resolution (subproblem 2). Tracking is dispatched through the engine
registry in tracking.py:

  engine="dense"                plain PyTorch: windowed range-max tracking,
                                then the greedy fold
  engine="dense_pallas_fused"   tracking, compaction and the greedy fold in
                                ONE CUDA kernel launch per candidate batch
                                (kernels/episode_track.py)

  engine="dense_pallas"         one CUDA kernel launch per tracking level
                                for the whole batch, then the greedy fold

All return identical counts and carried chain state.
:func:`count_batch_dispatch` is the one counting dispatch: engines exposing
``count_batch`` run the whole pipeline natively, every other engine tracks
and folds the greedy here. :func:`count_corpus_indexed` counts one
candidate batch against a corpus of streams.

Entry points that take host data (:func:`count_nonoverlapped`,
:func:`count_batch_indexed`, :func:`count_corpus_indexed`) run on
``device``, the card by default; the tensor-level functions run on their
tensors' device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import resolve_device
from . import events as events_lib
from . import plan as plan_mod
from . import scheduling, tracking
from .episodes import Episode


@dataclasses.dataclass
class CountResult:
    count: torch.Tensor        # i32 non-overlapped occurrence count
    n_superset: torch.Tensor   # i32 size of the tracked (overlapping) superset
    overflow: torch.Tensor     # bool static-capacity overflow indicator


def _fresh_carries(batch: int, device):
    return (torch.full((batch,), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros(batch, dtype=torch.int32, device=device))


def count_batch_dispatch(
    engine,                        # str name or TrackingEngine
    times_by_sym: torch.Tensor,    # f32[..., N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,           # f32[..., N-1]
    t_high: torch.Tensor,          # f32[..., N-1]
    prev_end: torch.Tensor,        # f32[...] greedy carry in
    prev_count: torch.Tensor,      # i32[...] count carry in
    cfg: tracking.EngineConfig,
    *,
    parallel_schedule: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched counting through any engine — THE one counting dispatch.

    Engines exposing ``count_batch`` run tracking, compaction and greedy
    scheduling in one kernel launch; everything else tracks via
    :func:`tracking.track_batch_dispatch` and folds the greedy here.
    ``cfg.t_min`` is consumed HERE (seed-row restriction). The two
    schedulers are bit-identical including carried state, so the in-kernel
    fold serves both ``parallel_schedule`` settings.

    Returns ``(counts i32[...], end_out f32[...], n_superset i32[...],
    overflow bool[...])`` with the ``(prev_end, prev_count)`` carry folded
    in. Stacked leading dims are folded into one batch axis and unfolded
    on the way out.
    """
    lead = times_by_sym.shape[:-2]
    if len(lead) > 1:
        rows = math.prod(lead)
        counts, end_out, nsup, ovf = count_batch_dispatch(
            engine,
            times_by_sym.reshape((rows,) + tuple(times_by_sym.shape[-2:])),
            t_low.reshape((rows,) + tuple(t_low.shape[-1:])),
            t_high.reshape((rows,) + tuple(t_high.shape[-1:])),
            prev_end.reshape(rows), prev_count.reshape(rows),
            cfg, parallel_schedule=parallel_schedule)
        return (counts.reshape(lead), end_out.reshape(lead),
                nsup.reshape(lead), ovf.reshape(lead))
    eng = tracking.get_engine(engine) if isinstance(engine, str) else engine
    times_by_sym, cfg = tracking.consume_seed_restriction(times_by_sym, cfg)
    dev = times_by_sym.device
    prev_end = torch.as_tensor(prev_end, dtype=torch.float32, device=dev)
    prev_count = torch.as_tensor(prev_count, dtype=torch.int32, device=dev)
    count_batch = getattr(eng, "count_batch", None)
    if count_batch is not None:
        return count_batch(times_by_sym, t_low, t_high, prev_end, prev_count,
                           cfg)
    occ = tracking.track_batch_dispatch(eng, times_by_sym, t_low, t_high, cfg)
    end_out, count_out = _greedy_batch_state(
        occ, prev_end, prev_count, parallel_schedule=parallel_schedule)
    return count_out, end_out, occ.n_superset, occ.overflow


def _greedy_batch_state(occ, prev_end, prev_count, parallel_schedule):
    """The stateful greedy over batch-leading Occurrences — THE one greedy
    epilogue every batched counter shares. Returns ``(end_out f32[B],
    count_out i32[B])``."""
    return scheduling.greedy_state(occ, prev_end, prev_count,
                                   parallel=parallel_schedule)


def count_occurrences(
    times_by_sym: torch.Tensor,
    t_low: torch.Tensor,
    t_high: torch.Tensor,
    *,
    engine: str = "dense",
    parallel_schedule: bool = False,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
    t_min=None,
) -> CountResult:
    """Count one episode on its pre-gathered ``[N, cap]`` time table, on the
    table's device. ``t_min`` restricts the count to occurrences seeded at
    time >= ``t_min``."""
    bn, bp, wt, chunk = plan_mod.resolve_tiles(
        block_next=block_next, block_prev=block_prev,
        window_tiles=window_tiles)
    cfg = tracking.EngineConfig(block_next=bn, block_prev=bp,
                                window_tiles=wt, chunk=chunk, t_min=t_min)
    count, _, n_superset, overflow = count_batch_dispatch(
        engine, times_by_sym[None], t_low[None], t_high[None],
        *_fresh_carries(1, times_by_sym.device), cfg,
        parallel_schedule=parallel_schedule)
    return CountResult(
        count=count[0], n_superset=n_superset[0], overflow=overflow[0])


def count_nonoverlapped(
    stream: events_lib.EventStream,
    episode: Episode,
    *,
    engine: str = "dense",
    cap: Optional[int] = None,
    parallel_schedule: bool = False,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
    device="cuda",
) -> CountResult:
    """End-to-end count for one episode on one stream (public API), on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    # `is None`, not `or`: an explicit cap=0 must reach type_index's check
    cap = max(1, stream.n_events) if cap is None else cap
    table, counts = events_lib.type_index(
        stream.types.to(dev), stream.times.to(dev), stream.n_types, cap)
    sym, lo, hi = episode.as_arrays(dev)
    times_by_sym, _ = events_lib.episode_symbol_times(table, counts, sym)
    res = count_occurrences(
        times_by_sym, lo, hi, engine=engine,
        parallel_schedule=parallel_schedule, block_next=block_next,
        block_prev=block_prev, window_tiles=window_tiles)
    per_type_overflow = (counts > cap).any()
    return CountResult(res.count, res.n_superset,
                       res.overflow | per_type_overflow)


# ---------------------------------------------------------------------------
# MiningPlan builder: the function dispatch runs for a plan. `build_cap` is
# the width the index was *built* at: adapters pad tables to the plan's
# capacity class with +inf, so overflow compares against the build width,
# not the padded width — the unpadded semantics exactly.
# ---------------------------------------------------------------------------


def _engine_cfg(p: plan_mod.MiningPlan) -> tracking.EngineConfig:
    return tracking.EngineConfig(
        block_next=p.block_next, block_prev=p.block_prev,
        window_tiles=p.window_tiles, chunk=p.chunk)


def _build_count_indexed(p: plan_mod.MiningPlan):
    def fn(table, counts, build_cap, symbols, t_low, t_high):
        index_overflow = (counts > build_cap).any()
        batch_counts, _, n_superset, overflow = count_batch_dispatch(
            tracking.get_engine(p.engine), table[symbols.long()], t_low,
            t_high, *_fresh_carries(symbols.shape[0], table.device),
            _engine_cfg(p), parallel_schedule=p.parallel_schedule)
        return batch_counts, n_superset, overflow | index_overflow
    return fn


plan_mod.register_fn("count_indexed", _build_count_indexed)


def _build_count_corpus(p: plan_mod.MiningPlan):
    def fn(tables, counts, build_cap, symbols, t_low, t_high, thresholds):
        s, b = tables.shape[0], symbols.shape[0]
        index_overflow = (counts > build_cap).any(dim=-1)          # [S]
        eng = tracking.get_engine(p.engine)
        cfg = _engine_cfg(p)
        gathered = tables[:, symbols.long()]                       # [S, B, N, cap]
        if getattr(eng, "count_batch", None) is not None:
            # corpus-native counting: (stream, episode) rows fold into ONE
            # single-launch count pipeline call, fresh carries
            corpus_counts, _, n_superset, overflow = count_batch_dispatch(
                eng, gathered, t_low.expand(s, -1, -1),
                t_high.expand(s, -1, -1), *_fresh_carries(s * b, tables.device),
                cfg, parallel_schedule=p.parallel_schedule)
        else:
            occ = tracking.track_corpus_dispatch(eng, gathered, t_low, t_high,
                                                 cfg)
            fresh_end, fresh_count = _fresh_carries(1, tables.device)
            _, corpus_counts = _greedy_batch_state(
                occ, fresh_end[0], fresh_count[0], p.parallel_schedule)
            n_superset, overflow = occ.n_superset, occ.overflow
        keep = corpus_counts >= thresholds[:, None]
        return (corpus_counts, keep, n_superset,
                overflow | index_overflow[:, None])
    return fn


plan_mod.register_fn("count_corpus", _build_count_corpus)


def count_batch_indexed(
    table,                  # f32[n_types, cap] per-type time index
    counts,                 # i32[n_types] true per-type totals (pre-clip)
    symbols,                # i32[B, N]
    t_low,                  # f32[B, N-1]
    t_high,                 # f32[B, N-1]
    *,
    engine: str = "dense",
    parallel_schedule: bool = False,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
    build_cap: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count a batch of same-length episodes on a *pre-built* type index.

    The miner builds the index once per stream and calls this for every
    level. Returns (counts i32[B], n_superset i32[B], overflow bool[B]) on
    ``device``.

    Adapter over the MiningPlan spine: the (level, cap-class, batch-class,
    engine, knobs) bucket resolves one plan, the inputs are padded to it
    and dispatched. ``build_cap`` is the width the index was built at when
    the caller pre-padded the table (default: the table's width).
    """
    dev = resolve_device(device)
    table = torch.as_tensor(table, dtype=torch.float32, device=dev)
    counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    symbols = torch.as_tensor(symbols, dtype=torch.int32, device=dev)
    t_low = torch.as_tensor(t_low, dtype=torch.float32, device=dev)
    t_high = torch.as_tensor(t_high, dtype=torch.float32, device=dev)
    if build_cap is None:
        build_cap = table.shape[1]
    b, n = symbols.shape
    if b == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, torch.zeros(0, dtype=torch.bool, device=dev)
    p = plan_mod.plan_for(
        "count_indexed", level=n, n_types=table.shape[0],
        cap=table.shape[1], batch=b, engine=engine,
        parallel_schedule=parallel_schedule, block_next=block_next,
        block_prev=block_prev, window_tiles=window_tiles)
    out = plan_mod.dispatch(
        p, plan_mod.pad_width(table, p.cap, float("inf")), counts,
        int(build_cap), plan_mod.pad_rows(symbols, p.batch),
        plan_mod.pad_rows(t_low, p.batch), plan_mod.pad_rows(t_high, p.batch))
    return tuple(a[:b] for a in out)


def count_corpus_indexed(
    tables,                 # f32[S, n_types, cap] per-stream type indexes
    counts,                 # i32[S, n_types] true per-type totals (pre-clip)
    symbols,                # i32[B, N] shared candidate batch
    t_low,                  # f32[B, N-1]
    t_high,                 # f32[B, N-1]
    thresholds,             # i32[S] per-stream frequency thresholds
    *,
    engine: str = "dense",
    parallel_schedule: bool = False,
    block_next: Optional[int] = None,
    block_prev: Optional[int] = None,
    window_tiles: Optional[int] = None,
    build_cap: Optional[int] = None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count one candidate batch against a whole corpus of streams at once.

    The stream axis of the pre-built batched type index
    (:func:`events.type_index_batch`) folds into the candidate-batch
    dimension: with ``dense_pallas_fused`` the whole ``S x B`` grid is ONE
    count kernel launch, with ``dense_pallas`` one track_level launch per
    tracking level. Every stream's keep mask is computed on ``device``
    against its own threshold, so the corpus miner fetches counts, keep
    and overflow for all streams in one host sync per level.

    Adapter over the MiningPlan spine: the stream axis rounds to its own
    capacity class (padded streams are all-+inf, count nothing and are
    sliced away). Returns ``(counts i32[S, B], keep bool[S, B],
    n_superset i32[S, B], overflow bool[S, B])``; each row is what
    :func:`count_batch_indexed` returns for that stream alone.
    """
    dev = resolve_device(device)
    tables = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    counts = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    symbols = torch.as_tensor(symbols, dtype=torch.int32, device=dev)
    t_low = torch.as_tensor(t_low, dtype=torch.float32, device=dev)
    t_high = torch.as_tensor(t_high, dtype=torch.float32, device=dev)
    thresholds = torch.as_tensor(thresholds, dtype=torch.int32, device=dev)
    s = tables.shape[0]
    if tuple(thresholds.shape) != (s,):
        raise ValueError(f"thresholds must have shape ({s},), got "
                         f"{tuple(thresholds.shape)}")
    if build_cap is None:
        build_cap = tables.shape[2]
    b, n = symbols.shape
    if b == 0:
        zi = torch.zeros((s, 0), dtype=torch.int32, device=dev)
        zb = torch.zeros((s, 0), dtype=torch.bool, device=dev)
        return zi, zb, zi, zb
    p = plan_mod.plan_for(
        "count_corpus", level=n, n_types=tables.shape[1], cap=tables.shape[2],
        batch=b, streams=s, engine=engine,
        parallel_schedule=parallel_schedule, block_next=block_next,
        block_prev=block_prev, window_tiles=window_tiles)
    tables = plan_mod.pad_width(tables, p.cap, float("inf"))
    if p.streams != s:
        # padded streams are empty (+inf index, zero counts and thresholds)
        extra = p.streams - s
        tables = torch.cat([tables, tables.new_full(
            (extra,) + tuple(tables.shape[1:]), float("inf"))])
        counts = torch.cat([counts, counts.new_zeros(
            (extra,) + tuple(counts.shape[1:]))])
        thresholds = torch.cat([thresholds, thresholds.new_zeros(extra)])
    out = plan_mod.dispatch(
        p, tables, counts, int(build_cap), plan_mod.pad_rows(symbols, p.batch),
        plan_mod.pad_rows(t_low, p.batch), plan_mod.pad_rows(t_high, p.batch),
        thresholds)
    return tuple(a[:s, :b] for a in out)

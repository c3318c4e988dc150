"""Multi-stream batched mining: one level loop for a whole corpus.

The paper counts one spike train at a time; its users analyse corpora —
many recordings or trials per experiment. :func:`mine_corpus` runs the
Apriori level loop ONCE for a padded batch of ``S`` independent streams:

* the per-stream type indexes are built in one batched scatter on the
  device (:func:`events.type_index_batch`); ragged stream lengths cost
  ``+inf`` padding inside the shared capacity, never extra launches;
* per level, each running stream's candidate frontier is joined on the
  host (exactly :func:`mining.generate_candidates_arrays` per stream), the
  frontiers are deduplicated into one *union* batch, and the union is
  counted against every stream through one dispatch
  (:func:`counting.count_corpus_indexed`: with ``dense_pallas_fused`` the
  whole ``S x B`` grid is ONE count kernel launch);
* per-stream thresholds are applied on the device (the keep masks ride
  back with the counts), so each level pays exactly ONE host sync for the
  whole corpus;
* streams whose frontier empties go *quiet*: they stop contributing
  candidates and their rows of the fetched arrays are never read, so
  their overflow flags are masked too (they count nothing, as in their
  solo run).

Results are bit-for-bit ``[mine_arrays(s) for s in streams]``: tracking,
scheduling and overflow are per-(stream, episode) row.

Aggregation: ``per_stream`` always; ``corpus`` ("frequent in >= m
streams") when ``min_streams`` is given — per level the episodes frequent
in at least ``m`` streams, with ``counts`` = the number of supporting
streams (support, not occurrence totals: corpora mix recordings of
different lengths).

Sharding the stream axis over several cards (``cfg.mesh``) is not ported
yet and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import counting
from . import events as events_lib
from . import plan as plan_mod
from .events import EventStream
from .mining import (_OVERFLOW_MSG, LevelArrays, MinerConfig, _check_local,
                     _prune_level, generate_candidates_arrays,
                     pad_candidate_rows)


@dataclasses.dataclass
class CorpusResult:
    """Per-stream frequent sets plus the optional corpus-level aggregate."""

    per_stream: List[Dict[int, LevelArrays]]
    corpus: Optional[Dict[int, LevelArrays]] = None


def pad_corpus(
    streams: Sequence[EventStream],
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Stack a ragged corpus into padded ``[S, L]`` host arrays.

    Types pad with ``-1`` (dropped by the type index), times with ``+inf``.
    All streams must share one alphabet: level-1 results depend on
    ``n_types``. Returns ``(types i32[S, L], times f32[S, L], n_types)``.
    """
    if not streams:
        raise ValueError("mine_corpus needs at least one stream")
    alphabet = {s.n_types for s in streams}
    if len(alphabet) != 1:
        raise ValueError(
            f"corpus streams must share one n_types, got {sorted(alphabet)}")
    n_types = alphabet.pop()
    length = max(1, max(s.n_events for s in streams))
    types = np.full((len(streams), length), -1, np.int32)
    times = np.full((len(streams), length), np.inf, np.float32)
    for i, s in enumerate(streams):
        n = s.n_events
        types[i, :n] = s.types.cpu().numpy()
        times[i, :n] = s.times.cpu().numpy()
    return types, times, n_types


def _level_thresholds(
    thresholds: np.ndarray, level: int, cfg: MinerConfig
) -> np.ndarray:
    """Per-stream thresholds for one level: a per-level override (shared
    by every stream) beats the per-stream base, as ``mine_arrays``
    resolves it per stream."""
    override = (cfg.level_thresholds or {}).get(level)
    if override is not None:
        return np.full_like(thresholds, override)
    return thresholds


def union_candidates(frontiers: Sequence[np.ndarray]):
    """Dedup per-stream candidate frontiers into one union batch.

    ``frontiers`` are same-width ``i32[b_i, N]`` row blocks. Returns
    ``(union i32[U, N], inverse i[sum b_i])``: block ``i``'s rows are
    ``union[inverse[offset_i : offset_i + b_i]]``.
    """
    stacked = np.concatenate(list(frontiers), axis=0)
    union, inverse = np.unique(stacked, axis=0, return_inverse=True)
    return union.astype(np.int32), inverse.reshape(-1)


def aggregate_min_streams(
    per_stream: Sequence[Dict[int, LevelArrays]], min_streams: int
) -> Dict[int, LevelArrays]:
    """Corpus-level "frequent in >= m streams" aggregation.

    Per level: the union of per-stream frequent sets (a stream's rows are
    distinct, so multiplicity == supporting streams), kept when supported
    by at least ``min_streams`` streams. ``symbols`` are in lexicographic
    row order, ``counts`` is the support and ``n_candidates`` the union
    size before the support cut.
    """
    if min_streams < 1:
        raise ValueError(f"min_streams must be >= 1, got {min_streams}")
    out: Dict[int, LevelArrays] = {}
    for lvl in sorted({lvl for res in per_stream for lvl in res}):
        rows = [res[lvl].symbols for res in per_stream
                if lvl in res and res[lvl].symbols.shape[0]]
        if not rows:
            out[lvl] = LevelArrays(
                np.zeros((0, lvl), np.int32), np.zeros((0,), np.int32), 0)
            continue
        union, support = np.unique(np.concatenate(rows, axis=0), axis=0,
                                   return_counts=True)
        keep = support >= min_streams
        out[lvl] = LevelArrays(
            union[keep].astype(np.int32), support[keep].astype(np.int32),
            union.shape[0])
    return out


def mine_corpus(
    streams: Sequence[EventStream],
    cfg: MinerConfig,
    *,
    thresholds: Optional[Sequence[int]] = None,
    min_streams: Optional[int] = None,
) -> CorpusResult:
    """Level-wise mining of ``S`` independent streams in one device loop,
    on ``cfg.device``.

    Args:
      streams: the corpus; ragged lengths and empty streams are fine. All
        must share one ``n_types``.
      cfg: the usual :class:`MinerConfig`; ``cfg.threshold`` is the default
        per-stream threshold.
      thresholds: optional per-stream threshold overrides, length ``S``.
      min_streams: enable the ">= m streams" aggregate (default
        ``cfg.min_streams``; ``None`` disables it).

    Returns a :class:`CorpusResult` whose ``per_stream[i]`` equals
    ``mine_arrays(streams[i], cfg_i)`` bit for bit (``cfg_i`` = ``cfg``
    with that stream's threshold).
    """
    dev = _check_local(cfg)
    n_streams = len(streams)
    types, times, n_types = pad_corpus(streams)
    if thresholds is None:
        thr_base = np.full((n_streams,), cfg.threshold, np.int32)
    else:
        thr_base = np.asarray(thresholds, np.int32)
        if thr_base.shape != (n_streams,):
            raise ValueError(f"thresholds must have shape ({n_streams},), "
                             f"got {thr_base.shape}")
    if min_streams is None:
        min_streams = cfg.min_streams
    # `is None`, not `or`: an explicit cap=0 must reach type_index's error
    cap = types.shape[1] if cfg.cap is None else cfg.cap

    tables, type_counts = events_lib.type_index_batch(
        torch.as_tensor(types, device=dev), torch.as_tensor(times, device=dev),
        n_types, cap)                                     # built ONCE
    binc = type_counts.cpu().numpy()                      # level-1 host sync
    # pad ONCE to the plan bucket (capacity class of the width and of the
    # stream axis; all-+inf streams count nothing and are sliced away), so
    # every level lands on its bucket; build_cap keeps the overflow check
    # at the true build width
    tables = plan_mod.pad_width(tables, plan_mod.capacity_class(cap),
                                float("inf"))
    s_pad = plan_mod.capacity_class(n_streams) - n_streams
    if s_pad:
        tables = torch.cat([tables, tables.new_full(
            (s_pad,) + tuple(tables.shape[1:]), float("inf"))])
        type_counts = torch.cat([type_counts, type_counts.new_zeros(
            (s_pad, n_types))])

    def count_level(sym, lo, hi, thr):
        return counting.count_corpus_indexed(
            tables, type_counts, sym, lo, hi,
            np.concatenate([thr, np.zeros((s_pad,), np.int32)]),
            engine=cfg.engine, parallel_schedule=cfg.parallel_schedule,
            block_next=cfg.block_next, block_prev=cfg.block_prev,
            window_tiles=cfg.window_tiles, build_cap=cap, device=dev)

    # level 1: per-stream single-type episodes (one transfer did all S)
    results: List[Dict[int, LevelArrays]] = []
    frontier: List[np.ndarray] = []
    running = np.ones((n_streams,), bool)
    for s in range(n_streams):
        freq_types = np.nonzero(binc[s] >= thr_base[s])[0].astype(np.int32)
        results.append({1: _prune_level(freq_types, binc[s], n_types)})
        frontier.append(freq_types[:, None])

    for level in range(2, cfg.max_level + 1):
        # each running stream's own join, exactly the per-stream join
        joined: Dict[int, np.ndarray] = {}
        for s in range(n_streams):
            if not running[s]:
                continue
            if frontier[s].shape[0] == 0:
                running[s] = False                        # quiet: no record
                continue
            cands = generate_candidates_arrays(frontier[s], level, cfg)
            if cands.shape[0] == 0:
                results[s][level] = LevelArrays(
                    np.zeros((0, level), np.int32), np.zeros((0,), np.int32), 0)
                running[s] = False
                continue
            joined[s] = cands
        if not joined:
            break

        # the union is counted in chunks of max_candidates (a PER-STREAM
        # valve: S disjoint frontiers stack up to S times that), which
        # bounds the [S, chunk, N, cap] gather; rows are independent, so
        # chunking cannot change a result. One host sync for all chunks.
        union, inverse = union_candidates(list(joined.values()))
        thr = _level_thresholds(thr_base, level, cfg)
        chunk = max(cfg.max_candidates, 1)
        parts = []
        for start in range(0, union.shape[0], chunk):
            rows = union[start:start + chunk]
            counts_dev, keep_dev, _, overflow_dev = count_level(
                *pad_candidate_rows(rows, level, cfg, dev), thr)
            m = rows.shape[0]
            parts.append(torch.stack([
                counts_dev[:n_streams, :m], keep_dev[:n_streams, :m].int(),
                overflow_dev[:n_streams, :m].int()]))
        fetched = torch.cat(parts, dim=2).cpu().numpy()   # the one sync
        counts_h, keep_h, overflow_h = fetched[0], fetched[1] != 0, fetched[2]

        # un-union: each stream reads its own candidates' rows; quiet
        # streams' rows (and their flags) are never read
        offset = 0
        for s, cands in joined.items():
            idx = inverse[offset:offset + cands.shape[0]]
            offset += cands.shape[0]
            if overflow_h[s, idx].any():
                raise RuntimeError(f"stream {s}: {_OVERFLOW_MSG}")
            kept = keep_h[s, idx]
            frontier[s] = cands[kept]
            results[s][level] = LevelArrays(
                frontier[s], counts_h[s, idx][kept].astype(np.int32),
                cands.shape[0])

    corpus = (aggregate_min_streams(results, min_streams)
              if min_streams is not None else None)
    return CorpusResult(per_stream=results, corpus=corpus)

"""Level-wise (Apriori-style) frequent episode discovery (paper §II-C).

At each level N, candidate N-node episodes are generated from frequent
(N-1)-node episodes by the suffix/prefix join (alpha[1:] == beta[:-1]);
their non-overlapped counts come from one batched pass over the stream —
the counting step the paper accelerates — and candidates below the
frequency threshold are pruned (the non-overlapped count is
anti-monotone under sub-episodes, so the search stays complete).

Candidates live as padded ``i32[B, N]`` symbol rows (windows are uniform
per MinerConfig, so ``f32[B, N-1]`` windows are broadcast fills), the join
is a vectorized numpy group-by over symbol rows
(:func:`generate_candidates_arrays`), the per-type event index is built
**once per stream** on the device and reused by every level through
``counting.count_batch_indexed``, and pruning runs on the device: each
level pays exactly one host transfer, which brings counts, keep mask and
overflow back together. With ``engine="dense_pallas_fused"`` each level is
ONE kernel launch; with ``engine="dense_pallas"`` it is one launch per
tracking level. ``core/corpus.py`` runs the same loop for many streams.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import counting
from . import events as events_lib
from . import plan as plan_mod
from .episodes import Episode, episode_batch, episodes_from_rows
from .events import EventStream

MAX_BATCH_PAD = 16  # minimum candidate-batch capacity class (see _pad_to)


@dataclasses.dataclass
class MinerConfig:
    t_low: float                 # shared inter-event window (low, high]
    t_high: float
    threshold: int               # minimum non-overlapped count
    level_thresholds: Optional[Dict[int, int]] = None  # per-level override
    max_level: int = 4
    engine: str = "dense"        # any registered tracking engine (tracking.py)
    cap: Optional[int] = None    # per-type event capacity (default: n_events)
    parallel_schedule: bool = False  # binary-lifting greedy instead of the scan
    max_candidates: int = 4096   # safety valve per level
    # tile shape of the reference's window scan (None = the port's defaults
    # 256/256/0); window_tiles > 0 flags possible truncation (the miner
    # raises), exactly as in the reference
    block_next: Optional[int] = None
    block_prev: Optional[int] = None
    window_tiles: Optional[int] = None
    device: str = "cuda"         # "cpu" only when the caller asks for it
    mesh: Optional[object] = None  # sharded mining: not in the port yet
    # corpus mining (core/corpus.py): default of the ">= m streams"
    # aggregate; None = per-stream results only
    min_streams: Optional[int] = None


@dataclasses.dataclass
class LevelResult:
    episodes: List[Episode]
    counts: List[int]
    n_candidates: int


@dataclasses.dataclass
class LevelArrays:
    """Array-form per-level result: surviving episodes as symbol rows."""

    symbols: np.ndarray     # i32[F, N] surviving (frequent) episodes
    counts: np.ndarray      # i32[F] their non-overlapped counts
    n_candidates: int       # candidates generated at this level (pre-prune)


_OVERFLOW_MSG = (
    "episode counting overflowed static capacity or truncated a "
    "constraint window; raise cap/window_tiles")


def _pad_to(n: int) -> int:
    """Candidate batches pad to capacity classes (pow2, floor 16), the
    MiningPlan bucket's own rounding, so a padded batch lands on its
    bucket without re-padding."""
    return plan_mod.capacity_class(n, floor=MAX_BATCH_PAD)


def _resolve_cap(cfg: MinerConfig, stream: EventStream) -> int:
    """Explicit cfg.cap wins even when falsy (a cap of 0 must reach
    type_index's ValueError, not become the default)."""
    return max(1, stream.n_events) if cfg.cap is None else cfg.cap


def _check_local(cfg: MinerConfig) -> torch.device:
    if cfg.mesh is not None:
        raise NotImplementedError(
            "sharded mining (MinerConfig.mesh) is not ported yet")
    return resolve_device(cfg.device)


def generate_candidates(
    frequent: Sequence[Episode], level: int, cfg: MinerConfig
) -> List[Episode]:
    """Suffix/prefix join of frequent (level-1)-node episodes (list form).

    Reference implementation; :func:`generate_candidates_arrays` is the
    vectorized twin used by the miner and must match it element-for-element.
    """
    if level == 2:
        types = sorted({e.symbols[0] for e in frequent})
        return [
            Episode((a, b), (cfg.t_low,), (cfg.t_high,))
            for a in types
            for b in types
        ][: cfg.max_candidates]
    by_prefix: Dict[Tuple[int, ...], List[Episode]] = {}
    for e in frequent:
        by_prefix.setdefault(e.symbols[:-1], []).append(e)
    out: List[Episode] = []
    for alpha in frequent:
        for beta in by_prefix.get(alpha.symbols[1:], []):
            out.append(
                Episode(
                    alpha.symbols + (beta.symbols[-1],),
                    alpha.t_low + (cfg.t_low,),
                    alpha.t_high + (cfg.t_high,),
                )
            )
            if len(out) >= cfg.max_candidates:
                return out
    return out


def generate_candidates_arrays(
    frequent: np.ndarray, level: int, cfg: MinerConfig
) -> np.ndarray:
    """Vectorized suffix/prefix join over symbol rows (numpy, on the host).

    Args:
      frequent: i32[F, level-1] symbol rows of the frequent episodes from
        the previous level, in discovery order.

    Returns i32[B, level] candidate rows in exactly the order of
    :func:`generate_candidates`, truncated to ``cfg.max_candidates``.
    """
    f = np.asarray(frequent, np.int32).reshape(-1, max(level - 1, 1))
    if f.shape[0] == 0:
        return np.zeros((0, level), np.int32)
    if level == 2:
        types = np.unique(f[:, 0])            # ascending, deduped
        a = np.repeat(types, types.size)      # a-major, b-minor nesting
        b = np.tile(types, types.size)
        return np.stack([a, b], axis=1).astype(np.int32)[: cfg.max_candidates]
    prefix, suffix = f[:, :-1], f[:, 1:]
    nf = f.shape[0]
    # Dense ids for (N-2)-symbol rows so the join is integer searchsorted.
    _, inv = np.unique(
        np.concatenate([prefix, suffix], axis=0), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    pref_id, suf_id = inv[:nf], inv[nf:]
    # Betas grouped by prefix id; stable sort keeps discovery order in-group
    # (the dict-of-lists insertion order of the list join).
    order = np.argsort(pref_id, kind="stable")
    lo = np.searchsorted(pref_id[order], suf_id, side="left")
    hi = np.searchsorted(pref_id[order], suf_id, side="right")
    reps = hi - lo                            # betas joined per alpha
    total = int(reps.sum())
    if total == 0:
        return np.zeros((0, level), np.int32)
    alpha_rows = np.repeat(np.arange(nf), reps)
    group_start = np.cumsum(reps) - reps
    within = np.arange(total) - np.repeat(group_start, reps)
    beta_rows = order[np.repeat(lo, reps) + within]
    out = np.concatenate([f[alpha_rows], f[beta_rows, -1:]], axis=1)
    return out.astype(np.int32)[: cfg.max_candidates]


def count_candidates(
    stream: EventStream, candidates: Sequence[Episode], cfg: MinerConfig
) -> np.ndarray:
    """Batched counting of equal-length candidates (padded to a batch
    class); raises on overflow."""
    dev = _check_local(cfg)
    if not candidates:
        return np.zeros((0,), np.int32)
    b = len(candidates)
    padded = list(candidates) + [candidates[0]] * (_pad_to(b) - b)
    sym, lo, hi = episode_batch(padded, dev)
    cap = _resolve_cap(cfg, stream)
    table, type_counts = events_lib.type_index(
        stream.types.to(dev), stream.times.to(dev), stream.n_types, cap)
    counts, _, overflow = counting.count_batch_indexed(
        table, type_counts, sym, lo, hi, engine=cfg.engine,
        parallel_schedule=cfg.parallel_schedule, block_next=cfg.block_next,
        block_prev=cfg.block_prev, window_tiles=cfg.window_tiles, device=dev)
    if bool(overflow[:b].any()):
        raise RuntimeError(_OVERFLOW_MSG)
    return counts[:b].cpu().numpy()


def pad_candidate_rows(cands: np.ndarray, level: int, cfg: MinerConfig,
                       device):
    """Pad a non-empty candidate-row batch to its batch class (repeating
    row 0 — counted, then discarded) and broadcast the uniform windows;
    returns ``(sym, lo, hi)`` tensors on ``device``."""
    b = cands.shape[0]
    bp = _pad_to(b)
    sym = np.concatenate([cands, np.broadcast_to(cands[:1], (bp - b, level))])
    lo = torch.full((bp, level - 1), cfg.t_low, dtype=torch.float32,
                    device=device)
    hi = torch.full((bp, level - 1), cfg.t_high, dtype=torch.float32,
                    device=device)
    return torch.as_tensor(sym, device=device), lo, hi


def _prune_level(frequent_types: np.ndarray, counts: np.ndarray,
                 n_types: int) -> LevelArrays:
    """Level-1 result from the per-type counts and a frequency threshold."""
    return LevelArrays(frequent_types[:, None],
                       counts[frequent_types].astype(np.int32), n_types)


def _mine_levels(cfg: MinerConfig, level1: LevelArrays, count_level,
                 device) -> Dict[int, LevelArrays]:
    """The Apriori level loop.

    ``count_level(sym, lo, hi) -> (counts i32[B], overflow bool[B])``
    counts one padded candidate batch on the device. Each level pays
    exactly ONE host transfer: counts, keep mask and overflow are stacked
    and copied back together.
    """
    results = {1: level1}
    frequent = level1.symbols
    for level in range(2, cfg.max_level + 1):
        if frequent.shape[0] == 0:
            break
        cands = generate_candidates_arrays(frequent, level, cfg)
        b = cands.shape[0]
        if b == 0:
            results[level] = LevelArrays(
                np.zeros((0, level), np.int32), np.zeros((0,), np.int32), 0)
            break
        sym, lo, hi = pad_candidate_rows(cands, level, cfg, device)
        thr = (cfg.level_thresholds or {}).get(level, cfg.threshold)
        counts_dev, overflow_dev = count_level(sym, lo, hi)
        keep_dev = counts_dev >= thr                          # pruned on device
        fetched = torch.stack(
            [counts_dev[:b], keep_dev[:b].to(torch.int32),
             overflow_dev[:b].to(torch.int32)]).cpu().numpy()  # the one sync
        counts_h, keep_h, overflow_h = fetched[0], fetched[1] != 0, fetched[2]
        if overflow_h.any():
            raise RuntimeError(_OVERFLOW_MSG)
        frequent = cands[keep_h]
        results[level] = LevelArrays(
            frequent, counts_h[keep_h].astype(np.int32), b)
    return results


def mine_arrays(stream: EventStream, cfg: MinerConfig) -> Dict[int, LevelArrays]:
    """Level-wise mining on ``cfg.device``; returns per-level symbol arrays.

    The per-type index is built once on the device; each level runs
    candidate counting + threshold pruning there and syncs exactly once.
    The candidate join runs on the host over compact int32 arrays.
    """
    dev = _check_local(cfg)
    cap = _resolve_cap(cfg, stream)
    table, type_counts = events_lib.type_index(
        stream.types.to(dev), stream.times.to(dev), stream.n_types, cap)
    # pad the index ONCE to its capacity class (+inf columns are inert), so
    # every level's call lands on its plan bucket; build_cap keeps the
    # overflow check at the true build width
    table = plan_mod.pad_width(table, plan_mod.capacity_class(cap),
                               float("inf"))

    # level 1: single-type episodes; count = per-type event count
    binc = type_counts.cpu().numpy()                        # level-1 host sync
    freq_types = np.nonzero(binc >= cfg.threshold)[0].astype(np.int32)

    def count_level(sym, lo, hi):
        counts_dev, _, overflow = counting.count_batch_indexed(
            table, type_counts, sym, lo, hi, engine=cfg.engine,
            parallel_schedule=cfg.parallel_schedule,
            block_next=cfg.block_next, block_prev=cfg.block_prev,
            window_tiles=cfg.window_tiles, build_cap=cap, device=dev)
        return counts_dev, overflow

    return _mine_levels(
        cfg, _prune_level(freq_types, binc, stream.n_types), count_level, dev)


def mine(stream: EventStream, cfg: MinerConfig) -> Dict[int, LevelResult]:
    """Run level-wise mining up to cfg.max_level. Returns per-level results:
    a thin Episode-list wrapper over :func:`mine_arrays`."""
    return {
        level: LevelResult(
            episodes_from_rows(la.symbols, cfg.t_low, cfg.t_high) if level > 1
            else [Episode((int(t),)) for t in la.symbols[:, 0]],
            [int(c) for c in la.counts],
            la.n_candidates,
        )
        for level, la in mine_arrays(stream, cfg).items()
    }

"""Overlap resolution (paper §IV-A, Algorithm 1) — subproblem 2.

Given candidate occurrence intervals sorted by end time, the size of the
largest non-overlapped subset is the classic greedy interval-scheduling
answer:

* :func:`greedy_scan_state` — the paper's sequential pass, a Python loop
  over the interval axis with the batch as a leading dimension.
* :func:`greedy_parallel_state` — the same answer by successor binary
  lifting: for each interval i its greedy successor is the first
  (end-sorted) interval j with ``s_j > e_i``, found by a sparse-table
  descent, and the chain length is counted with doubled jump tables.

Both take input sorted ascending by end time with invalid entries parked at
``end=+inf, start=-inf`` (the Occurrences convention), are seeded with the
carried ``(prev_end, count)`` state and return the final pair. The tie rule
is strict: an interval is taken iff ``start > prev_end``. The greedy is a
left fold, so running it over an end-sorted prefix and carrying the state
into the remainder gives exactly the whole-list answer.
"""
from __future__ import annotations

import torch

from .tracking import Occurrences, build_sparse_table

NEG = float("-inf")
INF = float("inf")


def greedy_scan_state(
    occ: Occurrences, prev_end: torch.Tensor, count: torch.Tensor
) -> tuple:
    """Paper Algorithm 1 seeded with carried state; returns the final
    ``(prev_end f32[...], count i32[...])``.

    The loop walks each row's valid intervals in their (end) order. Invalid
    entries never change the state, so moving them behind the valid ones
    first (a stable compaction) leaves the fold unchanged and bounds the
    loop by the longest row's valid count instead of the capacity.
    """
    valid = occ.valid
    m = valid.sum(-1)
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    s = torch.gather(occ.starts, -1, order)
    e = torch.gather(occ.ends, -1, order)
    prev_e = torch.as_tensor(prev_end, dtype=torch.float32,
                             device=s.device).expand(m.shape).clone()
    cnt = torch.as_tensor(count, dtype=torch.int32,
                          device=s.device).expand(m.shape).clone()
    steps = int(m.max()) if m.numel() else 0
    for j in range(steps):
        take = (m > j) & (s[..., j] > prev_e)
        prev_e = torch.where(take, e[..., j], prev_e)
        cnt = cnt + take.to(torch.int32)
    return prev_e, cnt


def _first_greater(table: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """For each v in ``values[..., m]``: first index i with starts[i] > v
    (cap if none). ``table`` is build_sparse_table(starts); the descent
    skips any block of 2^k whose max start is <= v."""
    levels, cap = table.shape[0], table.shape[-1]
    pos = torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    for k in range(levels - 1, -1, -1):
        width = 1 << k
        blockmax = torch.gather(table[k], -1, pos.clamp(0, cap - 1))
        advance = (pos + width <= cap) & (blockmax <= values)
        pos = torch.where(advance, pos + width, pos)
    return pos


def greedy_parallel_state(
    occ: Occurrences, prev_end: torch.Tensor, count: torch.Tensor
) -> tuple:
    """Binary-lifting scheduler seeded with carried state; returns the final
    state. The same fold as :func:`greedy_scan_state`: the entry point is
    the first end-sorted interval with ``start > prev_end``."""
    cap = occ.starts.shape[-1]
    shape = occ.starts.shape[:-1]
    dev = occ.starts.device
    prev_end = torch.as_tensor(prev_end, dtype=torch.float32,
                               device=dev).expand(shape)
    s = torch.where(occ.valid, occ.starts, NEG)
    e = torch.where(occ.valid, occ.ends, INF)
    table = build_sparse_table(s)

    # successor of interval i = first j with s_j > e_i (j > i holds because
    # s_j <= e_j and ends are sorted); sink index = cap
    nxt = _first_greater(table, e)                             # [..., cap]
    entry = _first_greater(table, prev_end[..., None])[..., 0]
    sink = torch.full(shape + (1,), cap, dtype=torch.int64, device=dev)
    jump = torch.cat([nxt, sink], dim=-1)                      # [..., cap+1]

    # tables[k] = successor^(2^k)
    levels = max(1, cap.bit_length())
    tables = [jump]
    for _ in range(1, levels):
        tables.append(torch.gather(tables[-1], -1, tables[-1]))

    # chain length from entry: largest m with successor^m(entry) != sink,
    # accumulated from the largest power of two down; the count of
    # selected intervals is m + 1 when the chain is non-empty
    pos = entry
    jumps = torch.zeros(shape, dtype=torch.int32, device=dev)
    for k in range(levels - 1, -1, -1):
        nxt_pos = torch.gather(tables[k], -1, pos[..., None])[..., 0]
        take = nxt_pos < cap
        jumps = jumps + torch.where(take, 1 << k, 0).to(torch.int32)
        pos = torch.where(take, nxt_pos, pos)
    took_any = entry < cap
    last = torch.gather(e, -1, pos.clamp(max=cap - 1)[..., None])[..., 0]
    final_end = torch.where(took_any, last, prev_end)
    total = (torch.as_tensor(count, dtype=torch.int32, device=dev) + jumps
             + took_any.to(torch.int32))
    return final_end, total


def greedy_state(
    occ: Occurrences,
    prev_end: torch.Tensor,
    count: torch.Tensor,
    parallel: bool = False,
) -> tuple:
    """Greedy fold over ``occ`` seeded with ``(prev_end, count)``; returns
    the final ``(prev_end, count)``."""
    fn = greedy_parallel_state if parallel else greedy_scan_state
    return fn(occ, prev_end, count)

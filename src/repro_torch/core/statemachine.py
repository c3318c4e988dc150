"""Sequential host oracles (paper §III-A, Fig 3), in numpy.

:func:`count_fsm_numpy` is the exact list-based FSM count of
[Patnaik et al. 2008] as the paper describes it; :func:`greedy_numpy` is
Algorithm 1 on a host. Both are ground truth for the counters, and
``chip_smoke.py`` checks mined counts against the FSM.

Tie convention: "non-overlapped" is strict — the next occurrence must
*start strictly after* the previous occurrence's end (``prev_e < s_i``).
The oracle compares windows in float64, the engines in float32, so the two
can disagree where ``t - s`` sits within float32 rounding of a window edge.
"""
from __future__ import annotations

import numpy as np

from .episodes import Episode


def count_fsm_numpy(types, times, episode: Episode, return_occurrences: bool = False):
    """Exact serial FSM count of non-overlapped occurrences (oracle).

    For each symbol j, ``lists[j]`` holds times of symbol-j events that extend
    some partial occurrence. On completing the last symbol the count is
    incremented and the whole data structure cleared (paper Fig 3).
    """
    types = np.asarray(types)
    times = np.asarray(times, np.float64)
    n = episode.n
    sym = episode.symbols
    lo, hi = episode.t_low, episode.t_high
    lists = [[] for _ in range(n)]
    count = 0
    prev_completion = -np.inf
    occs = []
    for e, t in zip(types, times):
        completed = False
        # highest position first so an event cannot chain off itself
        for j in range(n - 1, -1, -1):
            if e != sym[j]:
                continue
            if j == 0 and n == 1:
                if t > prev_completion:
                    count += 1
                    prev_completion = t
                    if return_occurrences:
                        occs.append(t)
                continue
            if j == 0:
                if t > prev_completion:
                    lists[0].append(t)
                continue
            ok = any(lo[j - 1] < t - s <= hi[j - 1] for s in lists[j - 1])
            if not ok:
                continue
            if j == n - 1:
                count += 1
                prev_completion = t
                if return_occurrences:
                    occs.append(t)
                lists = [[] for _ in range(n)]
                completed = True
                break
            lists[j].append(t)
        if completed:
            continue
    if return_occurrences:
        return count, occs
    return count


def greedy_numpy(starts, ends) -> int:
    """Paper Algorithm 1 on a host: intervals sorted by end time."""
    count = 0
    prev_e = -np.inf
    for s, e in zip(starts, ends):
        if prev_e < s:
            prev_e = e
            count += 1
    return count

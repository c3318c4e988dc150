"""Multi-neuron spike-train simulator (paper §V-A).

Inhomogeneous-Poisson network model of [Patnaik et al. 2008]: each of
``n_neurons`` artificial neurons fires at a base rate (paper: 64 neurons,
20 spikes/s of noise); directed connections raise the firing probability of
downstream neurons inside a delay window, so embedded cascades appear as
frequent serial episodes with inter-event constraints. Four 9-node episodes
are embedded by strengthening chains of connections, mirroring the paper's
datasets (Table II: 20 s .. 4000 s of simulated time).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.episodes import Episode
from ..core.events import EventStream


@dataclasses.dataclass
class NetworkConfig:
    n_neurons: int = 64
    base_rate: float = 20.0        # spontaneous spikes/s/neuron (noise)
    conn_strength: float = 0.9     # firing prob boost along a cascade edge
    delay_low: float = 0.001       # seconds (paper windows are ms-scale)
    delay_high: float = 0.005
    dt: float = 0.001              # simulation tick
    trigger_hz: float = 6.0        # cascade injection rate per episode
    n_embedded: int = 4
    episode_len: int = 9
    seed: int = 0


def embedded_episodes(cfg: NetworkConfig) -> List[Episode]:
    """The cascades wired into the network, as Episode objects (constraints
    in the same units as simulated time)."""
    rng = np.random.default_rng(cfg.seed)
    eps = []
    perm = rng.permutation(cfg.n_neurons)
    for i in range(cfg.n_embedded):
        syms = perm[i * cfg.episode_len:(i + 1) * cfg.episode_len]
        eps.append(Episode(
            tuple(int(s) for s in syms),
            (0.0,) * (cfg.episode_len - 1),
            (cfg.delay_high * 2,) * (cfg.episode_len - 1),
        ))
    return eps


def simulate(cfg: NetworkConfig, duration_s: float) -> EventStream:
    """Generate a spike train of ``duration_s`` seconds."""
    rng = np.random.default_rng(cfg.seed + 1)
    episodes = embedded_episodes(cfg)

    # base Poisson noise
    n_expect = cfg.base_rate * cfg.n_neurons * duration_s
    n_noise = rng.poisson(n_expect)
    t_noise = rng.uniform(0.0, duration_s, n_noise)
    e_noise = rng.integers(0, cfg.n_neurons, n_noise)

    # cascade injections: each episode triggers at ~trigger_hz; each trigger
    # walks the chain with per-edge success prob conn_strength and a random
    # delay in (delay_low, delay_high]
    t_extra, e_extra = [], []
    for ep in episodes:
        triggers = rng.uniform(0.0, duration_s,
                               max(1, rng.poisson(cfg.trigger_hz * duration_s)))
        for t0 in triggers:
            t = t0
            for sym in ep.symbols:
                t_extra.append(t)
                e_extra.append(sym)
                if rng.uniform() > cfg.conn_strength:
                    break
                t = t + rng.uniform(cfg.delay_low, cfg.delay_high)

    times = np.concatenate([t_noise, np.asarray(t_extra, np.float64)])
    types = np.concatenate([e_noise, np.asarray(e_extra, np.int64)])
    order = np.argsort(times, kind="stable")
    return EventStream(types[order].astype(np.int32),
                       times[order].astype(np.float32), cfg.n_neurons)


# Paper Table II dataset definitions (duration seconds). Events counts in
# the paper (~3.2k events/s) come from 64 neurons x ~50 sp/s including
# cascade traffic; our defaults reproduce the same scaling shape.
def noise_pair_estimate(cfg: NetworkConfig, duration_s: float) -> float:
    """Expected chance count of a 2-node episode under pure noise: events of
    the first type x P(second type within the window)."""
    w = 2 * cfg.delay_high
    return (cfg.base_rate * duration_s) * (cfg.base_rate * w)


PAPER_DATASETS: Tuple[Tuple[int, float], ...] = (
    (1, 4000.0), (2, 2000.0), (3, 1000.0), (4, 500.0),
    (5, 200.0), (6, 100.0), (7, 50.0), (8, 20.0),
)


def paper_dataset(idx: int, *, scale: float = 1.0,
                  cfg: NetworkConfig = None) -> EventStream:
    """Dataset ``idx`` (1..8) from Table II, optionally time-scaled down
    (CPU benchmarks use scale < 1 to bound runtime; the *relative* curves
    match the paper's figures)."""
    cfg = cfg or NetworkConfig()
    durations = dict(PAPER_DATASETS)
    return simulate(cfg, durations[idx] * scale)

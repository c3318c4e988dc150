"""Port parity: event streams, the per-type index, episodes and the spike
simulator of ``repro_torch`` against the JAX reference ``repro``.

Inputs are made from numpy seeds; the reference gets them directly, the
port through ``repro_torch.interop``. Tolerance 0: the index is a scatter
of the same float32 values, so tables and counts must match element for
element.
"""
import numpy as np
import pytest
import torch

from repro.core import episodes as r_episodes
from repro.core import events as r_events
from repro.core import tracking as r_tracking
from repro.data import spikes as r_spikes
from repro_torch import interop
from repro_torch.core import episodes as p_episodes
from repro_torch.core import events as p_events
from repro_torch.core import tracking as p_tracking
from repro_torch.data import spikes as p_spikes


def _stream(seed, n, n_types, *, pad=0, max_gap=5):
    """Zero gaps make duplicate timestamps; ``pad`` trailing -1 events."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.integers(0, max_gap + 1, n) * 0.25).astype(np.float32)
    types = rng.integers(0, n_types, n).astype(np.int32)
    if pad:
        types = np.concatenate([types, np.full(pad, -1, np.int32)])
        times = np.concatenate([times, np.full(pad, np.inf, np.float32)])
    return types, times


def _both_type_index(types, times, n_types, cap):
    r_table, r_counts = r_events.type_index(types, times, n_types, cap)
    s = interop.stream(types, times, n_types, "cpu")
    p_table, p_counts = p_events.type_index(s.types, s.times, n_types, cap)
    return (np.asarray(r_table), np.asarray(r_counts),
            p_table.numpy(), p_counts.numpy())


@pytest.mark.parametrize("seed,n,n_types,cap,pad", [
    (0, 50, 4, 64, 0),       # plain random stream
    (1, 200, 3, 64, 0),      # per-type overflow: events past cap dropped
    (2, 80, 5, 32, 7),       # -1 padding must not land in the last row
    (3, 1, 2, 1, 0),         # one event, cap 1
    (4, 120, 1, 257, 0),     # single type, odd cap, many duplicate times
])
def test_type_index_matches_reference(seed, n, n_types, cap, pad):
    types, times = _stream(seed, n, n_types, pad=pad)
    r_table, r_counts, p_table, p_counts = _both_type_index(
        types, times, n_types, cap)
    np.testing.assert_array_equal(p_table, r_table)
    np.testing.assert_array_equal(p_counts, r_counts)
    assert p_table.dtype == np.float32 and p_counts.dtype == np.int32


def test_type_index_all_padding_and_out_of_range_types():
    types = np.array([-1, -3, 7, -1], np.int32)      # nothing in [0, 4)
    times = np.array([0.0, 0.5, 1.0, np.inf], np.float32)
    r_table, r_counts, p_table, p_counts = _both_type_index(types, times, 4, 8)
    np.testing.assert_array_equal(p_table, r_table)
    np.testing.assert_array_equal(p_counts, r_counts)
    assert np.isinf(p_table).all() and not p_counts.any()


def test_type_index_rejects_cap_below_one():
    s = interop.stream(*_stream(5, 10, 3), 3, "cpu")
    with pytest.raises(ValueError, match="cap must be >= 1"):
        p_events.type_index(s.types, s.times, 3, 0)


def test_rank_within_type_matches_reference():
    types, _ = _stream(6, 300, 7)
    want = np.asarray(r_events._rank_within_type(types, 7))
    got = p_events._rank_within_type(torch.as_tensor(types), 7).numpy()
    np.testing.assert_array_equal(got, want)


def test_episode_symbol_times_matches_reference():
    types, times = _stream(7, 90, 4)
    r_table, r_counts = r_events.type_index(types, times, 4, 64)
    p_table, p_counts = interop.type_index(r_table, r_counts, "cpu")
    sym = [2, 0, 2, 3]
    want_t, want_c = r_events.episode_symbol_times(r_table, r_counts, sym)
    got_t, got_c = p_events.episode_symbol_times(p_table, p_counts, sym)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_episode_as_arrays_casts_windows_to_float32():
    kw = dict(symbols=(0, 1, 2), t_low=(0.1, 0.0), t_high=(0.3000001, 1e-3))
    want = [np.asarray(x) for x in r_episodes.Episode(**kw).as_arrays()]
    got = [x.numpy() for x in p_episodes.Episode(**kw).as_arrays("cpu")]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rows = np.array([[0, 1], [2, 3]], np.int32)
    r_eps = r_episodes.episodes_from_rows(rows, 0.1, 0.5)
    p_eps = p_episodes.episodes_from_rows(rows, 0.1, 0.5)
    assert [str(e) for e in p_eps] == [str(e) for e in r_eps]
    want = [np.asarray(x) for x in r_episodes.episode_batch(r_eps)]
    got = [x.numpy() for x in p_episodes.episode_batch(p_eps, "cpu")]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        p_episodes.Episode((0, 1), (0.5,), (0.5,))


@pytest.mark.parametrize("t_min", [-np.inf, 3.0, 1e9])
def test_restrict_seed_row_matches_reference(t_min):
    rng = np.random.default_rng(8)
    times = np.sort(rng.uniform(0, 10, (3, 2, 16)).astype(np.float32), axis=-1)
    times[1, 0, 9:] = np.inf
    want = np.asarray(r_tracking.restrict_seed_row(times, t_min))
    got = p_tracking.restrict_seed_row(
        interop.times_by_sym(times, "cpu"), t_min).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,duration", [(0, 0.5), (3, 2.0)])
def test_simulate_matches_reference(seed, duration):
    r_cfg = r_spikes.NetworkConfig(seed=seed)
    p_cfg = p_spikes.NetworkConfig(seed=seed)
    want = r_spikes.simulate(r_cfg, duration)
    got = p_spikes.simulate(p_cfg, duration)
    np.testing.assert_array_equal(got.types.numpy(), np.asarray(want.types))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    assert got.n_types == want.n_types
    assert ([e.symbols for e in p_spikes.embedded_episodes(p_cfg)]
            == [e.symbols for e in r_spikes.embedded_episodes(r_cfg)])
    assert (p_spikes.noise_pair_estimate(p_cfg, duration)
            == r_spikes.noise_pair_estimate(r_cfg, duration))

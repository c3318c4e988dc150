"""Port parity: candidate generation, counting entries and level-wise
mining of ``repro_torch`` against the JAX reference ``repro``.

Streams come from numpy seeds, from tests/data/golden_stream.npz (read
only) and from the stream examples/quickstart.py builds; the reference
gets them directly, the port through ``repro_torch.interop``, with the
reference's own MinerConfig carried across. Tolerance 0: every level must
hold the same candidate count, the same frequent rows in the same order
and the same counts. The reference runs its ``dense`` engine, which its
own tests hold bit for bit to its ``dense_pallas_fused`` kernel.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import counting as r_counting
from repro.core import events as r_events
from repro.core import mining as r_mining
from repro.core.episodes import serial as r_serial
from repro_torch import interop
from repro_torch.core import counting as p_counting
from repro_torch.core import mining as p_mining
from repro_torch.core.episodes import serial as p_serial

GOLDEN = Path(__file__).resolve().parent / "data" / "golden_stream.npz"
ENGINES = ("dense", "dense_pallas", "dense_pallas_fused")


def _grid_stream(seed, n, n_types):
    """Times on a 0.25 grid with zero gaps: duplicate timestamps and exact
    window-edge ties."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.integers(0, 4, n) * 0.25).astype(np.float32)
    return rng.integers(0, n_types, n).astype(np.int32), times, n_types


def _quickstart_stream():
    """The stream examples/quickstart.py mines: 6 types, Poisson noise and
    an embedded 0 -> 1 -> 2 cascade with 5-15 ms delays."""
    rng = np.random.default_rng(7)
    n_types, duration = 6, 30.0
    t_noise = rng.uniform(0, duration, rng.poisson(40 * duration))
    e_noise = rng.integers(0, n_types, t_noise.size)
    t_inj, e_inj = [], []
    for t0 in rng.uniform(0, duration, 60):
        t = t0
        for sym in (0, 1, 2):
            t_inj.append(t)
            e_inj.append(sym)
            t += rng.uniform(0.005, 0.015)
    times = np.concatenate([t_noise, t_inj])
    types = np.concatenate([e_noise, e_inj]).astype(np.int32)
    order = np.argsort(times)
    return types[order], times[order].astype(np.float32), n_types


def _golden():
    d = np.load(GOLDEN)
    cfg = dict(t_low=float(d["t_low"]), t_high=float(d["t_high"]),
               threshold=int(d["threshold"]), max_level=int(d["max_level"]),
               max_candidates=int(d["max_candidates"]))
    return (d["types"], d["times"], int(d["n_types"])), cfg


CASES = {
    "golden": _golden,
    "quickstart": lambda: (_quickstart_stream(), dict(
        t_low=0.004, t_high=0.016, threshold=30, max_level=3)),
    # ties, a per-level threshold and a candidate cap that truncates joins
    "grid": lambda: (_grid_stream(0, 300, 4), dict(
        t_low=0.25, t_high=1.0, threshold=5, max_level=5,
        max_candidates=40, level_thresholds={2: 9})),
}


@pytest.fixture(scope="module")
def reference_runs():
    """Each case mined once by the reference (engine 'dense')."""
    runs = {}
    for name, make in CASES.items():
        (types, times, n_types), kw = make()
        cfg = r_mining.MinerConfig(**kw)
        runs[name] = ((types, times, n_types), cfg, r_mining.mine_arrays(
            r_events.EventStream(types, times, n_types), cfg))
    return runs


def _assert_levels_equal(got, want):
    assert sorted(got) == sorted(want)
    for level in want:
        np.testing.assert_array_equal(got[level].symbols, want[level].symbols,
                                      err_msg=f"level {level}")
        np.testing.assert_array_equal(got[level].counts, want[level].counts,
                                      err_msg=f"level {level}")
        assert got[level].counts.dtype == np.int32
        assert got[level].n_candidates == want[level].n_candidates


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(CASES))
def test_mine_arrays_matches_reference(reference_runs, case, engine):
    (types, times, n_types), r_cfg, want = reference_runs[case]
    cfg = interop.miner_config(dataclasses.asdict(r_cfg), device="cpu")
    cfg.engine = engine
    got = p_mining.mine_arrays(interop.stream(types, times, n_types, "cpu"),
                               cfg)
    _assert_levels_equal(got, want)


def test_mine_arrays_recovers_golden_fixture():
    (types, times, n_types), kw = _golden()
    d = np.load(GOLDEN)
    got = p_mining.mine_arrays(
        interop.stream(types, times, n_types, "cpu"),
        p_mining.MinerConfig(**kw, engine="dense_pallas_fused", device="cpu"))
    assert sorted(got) == [int(x) for x in d["levels"]]
    for level in got:
        np.testing.assert_array_equal(got[level].symbols,
                                      d[f"level{level}_symbols"])
        np.testing.assert_array_equal(got[level].counts,
                                      d[f"level{level}_counts"])


def test_mine_episode_api_matches_reference(reference_runs):
    (types, times, n_types), r_cfg, _ = reference_runs["quickstart"]
    want = r_mining.mine(r_events.EventStream(types, times, n_types), r_cfg)
    cfg = interop.miner_config(dataclasses.asdict(r_cfg), device="cpu")
    got = p_mining.mine(interop.stream(types, times, n_types, "cpu"), cfg)
    assert sorted(got) == sorted(want)
    for level in want:
        assert ([str(e) for e in got[level].episodes]
                == [str(e) for e in want[level].episodes])
        assert got[level].counts == want[level].counts
        assert got[level].n_candidates == want[level].n_candidates
    assert any(e.symbols == (0, 1, 2) for e in got[3].episodes)


@pytest.mark.parametrize("level,max_candidates", [(2, 4096), (2, 5), (3, 4096),
                                                  (4, 4096), (4, 7)])
def test_generate_candidates_arrays_matches_reference(level, max_candidates):
    rng = np.random.default_rng(level * 10 + max_candidates)
    frequent = np.unique(rng.integers(0, 4, (14, level - 1)), axis=0)
    frequent = frequent[rng.permutation(len(frequent))].astype(np.int32)
    kw = dict(t_low=0.0, t_high=1.0, threshold=1,
              max_candidates=max_candidates)
    want = r_mining.generate_candidates_arrays(
        frequent, level, r_mining.MinerConfig(**kw))
    got = p_mining.generate_candidates_arrays(
        frequent, level, p_mining.MinerConfig(**kw, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # the list join gives the same rows in the same order
    from repro_torch.core.episodes import Episode
    eps = [Episode(tuple(r), (0.0,) * (level - 2), (1.0,) * (level - 2))
           for r in frequent]
    listed = p_mining.generate_candidates(
        eps, level, p_mining.MinerConfig(**kw, device="cpu"))
    assert [e.symbols for e in listed] == [tuple(r) for r in want]


def test_count_batch_indexed_build_cap_overflow_matches_reference():
    types, times, n_types = _grid_stream(2, 120, 3)
    r_table, r_counts = r_events.type_index(types, times, n_types, 24)
    r_table = np.concatenate(   # padded past the build width, as the miner does
        [np.asarray(r_table), np.full((n_types, 8), np.inf, np.float32)], 1)
    sym = np.array([[0, 1], [2, 2], [1, 0]], np.int32)
    lo = np.full((3, 1), 0.25, np.float32)
    hi = np.full((3, 1), 1.0, np.float32)
    for build_cap in (None, 24, 60):
        want = r_counting.count_batch_indexed(
            r_table, r_counts, sym, lo, hi, build_cap=build_cap)
        got = p_counting.count_batch_indexed(
            *interop.type_index(r_table, r_counts, "cpu"),
            *interop.candidates(sym, lo, hi, "cpu"), build_cap=build_cap,
            engine="dense_pallas_fused", device="cpu")
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2].all()) is False and bool(
        p_counting.count_batch_indexed(
            *interop.type_index(r_table, r_counts, "cpu"),
            *interop.candidates(sym, lo, hi, "cpu"), build_cap=24,
            device="cpu")[2].all())


_EPISODES = (([0, 1], 0.25, 1.0), ([1], 0.0, 1.0), ([3, 0, 1, 2], 0.25, 1.5))


@pytest.fixture(scope="module")
def nonoverlapped_case():
    types, times, n_types = _grid_stream(3, 200, 4)
    r_stream = r_events.EventStream(types, times, n_types)
    want = [r_counting.count_nonoverlapped(r_stream, r_serial(*e))
            for e in _EPISODES]
    return (types, times, n_types), want


@pytest.mark.parametrize("engine", ENGINES)
def test_count_nonoverlapped_matches_reference(nonoverlapped_case, engine):
    (types, times, n_types), want = nonoverlapped_case
    p_stream = interop.stream(types, times, n_types, "cpu")
    for (symbols, lo, hi), w in zip(_EPISODES, want):
        got = p_counting.count_nonoverlapped(
            p_stream, p_serial(symbols, lo, hi), engine=engine, device="cpu")
        for field in ("count", "n_superset", "overflow"):
            assert (getattr(got, field).item()
                    == np.asarray(getattr(w, field)).item()), field


def test_count_candidates_matches_reference():
    types, times, n_types = _grid_stream(4, 150, 3)
    kw = dict(t_low=0.25, t_high=1.0, threshold=1)
    eps = [r_serial(s, 0.25, 1.0) for s in ([0, 1], [1, 1], [2, 0], [0, 2])]
    want = r_mining.count_candidates(
        r_events.EventStream(types, times, n_types), eps,
        r_mining.MinerConfig(**kw))
    got = p_mining.count_candidates(
        interop.stream(types, times, n_types, "cpu"),
        [p_serial(e.symbols, 0.25, 1.0) for e in eps],
        p_mining.MinerConfig(**kw, engine="dense_pallas_fused", device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_unported_paths_raise(monkeypatch):
    cfg = r_mining.MinerConfig(t_low=0.0, t_high=1.0, threshold=1)
    fields = dataclasses.asdict(cfg)
    # the card by default: raises without one, "cuda" with one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.miner_config(fields)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert interop.miner_config(fields).device == "cuda"
    monkeypatch.undo()
    assert interop.miner_config(fields, device="cpu").device == "cpu"
    with pytest.raises(NotImplementedError, match="halo"):
        interop.miner_config({**fields, "halo": 64}, device="cpu")
    stream = interop.stream(*_grid_stream(5, 20, 2), "cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        p_mining.mine_arrays(stream, p_mining.MinerConfig(
            t_low=0.0, t_high=1.0, threshold=1, device="cpu", mesh=object()))

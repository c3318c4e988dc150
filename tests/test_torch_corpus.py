"""Port parity: corpus mining (``repro_torch.core.corpus``) and its layers —
the batched type index, the union of frontiers, the ">= m streams"
aggregate, ``count_corpus_indexed`` and ``ops.count_corpus`` — against the
JAX reference.

Corpora come from ``tests/strategies.py::make_corpus_case`` (ragged
lengths, duplicate timestamps, an all-padding stream every third seed,
per-stream thresholds), the golden stream and seeded random streams. The
reference mines with its ``dense`` engine; the port with ``dense``,
``dense_pallas`` and ``dense_pallas_fused`` (their plain versions, on the
CPU). Tolerance 0: every stream's levels must hold the same rows, counts
and candidate totals, and the aggregate the same rows and support.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import strategies as sts
from repro.core import corpus as r_corpus
from repro.core import counting as r_counting
from repro.core import events as r_events
from repro.core import mining as r_mining
from repro.kernels import ops as r_ops
from repro_torch import interop
from repro_torch.core import corpus as p_corpus
from repro_torch.core import counting as p_counting
from repro_torch.core import events as p_events
from repro_torch.core import mining as p_mining
from repro_torch.kernels import ops as p_ops

GOLDEN = Path(__file__).resolve().parent / "data" / "golden_stream.npz"
ENGINES = ("dense", "dense_pallas", "dense_pallas_fused")
SEEDS = (0, 1, 2, 3)    # seeds 0 and 3 hold an all-padding stream
CPU = "cpu"


def _rand_stream(seed, n, n_types=5, rate=0.3):
    rng = np.random.default_rng(seed)
    return r_events.EventStream(
        rng.integers(0, n_types, n).astype(np.int32),
        np.cumsum(rng.exponential(rate, n)).astype(np.float32), n_types)


def _assert_levels_equal(got, want, ctx=""):
    assert sorted(got) == sorted(want), ctx
    for level in want:
        np.testing.assert_array_equal(got[level].symbols, want[level].symbols,
                                      err_msg=f"{ctx} level {level}")
        np.testing.assert_array_equal(got[level].counts, want[level].counts,
                                      err_msg=f"{ctx} level {level}")
        assert got[level].counts.dtype == np.int32
        assert got[level].n_candidates == want[level].n_candidates, ctx


def _port_cfg(r_cfg, engine):
    cfg = interop.miner_config(dataclasses.asdict(r_cfg), device=CPU)
    cfg.engine = engine
    return cfg


@pytest.fixture(scope="module")
def corpus_runs():
    """Each seeded corpus mined once by the reference (engine 'dense'),
    with its per-stream thresholds, a shared level-3 override and the >= 2
    streams aggregate."""
    runs = {}
    for seed in SEEDS:
        streams, t_high, thresholds = sts.make_corpus_case(seed)
        cfg = r_mining.MinerConfig(t_low=0.0, t_high=t_high, threshold=1,
                                   level_thresholds={3: 3}, max_level=3,
                                   min_streams=2)
        runs[seed] = (streams, thresholds, cfg, r_corpus.mine_corpus(
            streams, cfg, thresholds=thresholds))
    return runs


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", SEEDS)
def test_mine_corpus_matches_reference(corpus_runs, seed, engine):
    streams, thresholds, r_cfg, want = corpus_runs[seed]
    got = p_corpus.mine_corpus(interop.corpus(streams, CPU),
                               _port_cfg(r_cfg, engine),
                               thresholds=thresholds)
    assert len(got.per_stream) == len(want.per_stream)
    for i, (g, w) in enumerate(zip(got.per_stream, want.per_stream)):
        _assert_levels_equal(g, w, f"stream {i}")
    _assert_levels_equal(got.corpus, want.corpus, "aggregate")


def test_mine_corpus_equals_per_stream_mine_arrays():
    """The port's own oracle: each stream's result is its solo run."""
    streams = [_rand_stream(i, n, n_types=4) for i, n in
               enumerate((60, 0, 33, 45))]
    cfg = p_mining.MinerConfig(t_low=0.0, t_high=1.5, threshold=3,
                               max_level=3, engine="dense_pallas_fused",
                               device=CPU)
    p_streams = interop.corpus(streams, CPU)
    got = p_corpus.mine_corpus(p_streams, cfg)
    assert got.corpus is None
    for i, s in enumerate(p_streams):
        _assert_levels_equal(got.per_stream[i], p_mining.mine_arrays(s, cfg),
                             f"stream {i}")


def test_mine_corpus_union_chunking_equals_per_stream_mine_arrays():
    """Disjoint frontiers (types 0-3 vs 4-7) stack past max_candidates, a
    per-stream valve: the union of 32 counts in chunks of 16 and every
    stream still equals its solo run."""
    rng = np.random.default_rng(7)
    streams = [(rng.integers(0, 4, 80) + lo_t,
                np.cumsum(rng.exponential(0.2, 80)), 8) for lo_t in (0, 4)]
    cfg = p_mining.MinerConfig(t_low=0.0, t_high=2.0, threshold=3,
                               max_level=3, max_candidates=16,
                               engine="dense_pallas_fused", device=CPU)
    p_streams = interop.corpus(streams, CPU)
    got = p_corpus.mine_corpus(p_streams, cfg)
    for i, s in enumerate(p_streams):
        assert got.per_stream[i][2].n_candidates == 16
        _assert_levels_equal(got.per_stream[i], p_mining.mine_arrays(s, cfg),
                             f"stream {i}")


def test_mine_corpus_recovers_golden():
    """The golden stream twice in a corpus beside a random stream: both
    copies reproduce the stored frequent sets, and the >= 2 streams
    aggregate holds every golden frequent row."""
    d = np.load(GOLDEN)
    golden = (d["types"], d["times"], int(d["n_types"]))
    noise = _rand_stream(9, 70, n_types=int(d["n_types"]))
    cfg = p_mining.MinerConfig(
        t_low=float(d["t_low"]), t_high=float(d["t_high"]),
        threshold=int(d["threshold"]), max_level=int(d["max_level"]),
        max_candidates=int(d["max_candidates"]), min_streams=2,
        engine="dense_pallas_fused", device=CPU)
    got = p_corpus.mine_corpus(interop.corpus([golden, noise, golden], CPU),
                               cfg)
    levels = [int(x) for x in d["levels"]]
    for s in (0, 2):
        assert sorted(got.per_stream[s]) == levels
        for level in levels:
            la = got.per_stream[s][level]
            np.testing.assert_array_equal(la.symbols,
                                          d[f"level{level}_symbols"])
            np.testing.assert_array_equal(la.counts, d[f"level{level}_counts"])
            assert la.n_candidates == int(d[f"level{level}_n_candidates"])
    for level in levels:
        want = {tuple(r) for r in d[f"level{level}_symbols"].tolist()}
        assert want <= {tuple(r) for r in got.corpus[level].symbols.tolist()}


def test_mine_corpus_validates_and_rejects_mesh():
    cfg = p_mining.MinerConfig(t_low=0.0, t_high=1.0, threshold=1,
                               device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        p_corpus.mine_corpus([], cfg)
    mixed = interop.corpus([_rand_stream(0, 10, n_types=3),
                            _rand_stream(1, 10, n_types=5)], CPU)
    with pytest.raises(ValueError, match="n_types"):
        p_corpus.mine_corpus(mixed, cfg)
    two = interop.corpus([_rand_stream(0, 10), _rand_stream(1, 10)], CPU)
    with pytest.raises(ValueError, match="thresholds"):
        p_corpus.mine_corpus(two, cfg, thresholds=[1, 2, 3])
    with pytest.raises(NotImplementedError, match="mesh"):
        p_corpus.mine_corpus(two, dataclasses.replace(cfg, mesh=object()))


# ---------------------------------------------------------------------------
# The layers: batched type index, union, aggregate, corpus counting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,cap", [(0, 64), (1, 7), (2, 40), (3, 3)])
def test_type_index_batch_matches_reference(seed, cap):
    streams, _, _ = sts.make_corpus_case(seed)
    types, times, n_types = r_corpus.pad_corpus(streams)
    p_types, p_times, p_n = p_corpus.pad_corpus(interop.corpus(streams, CPU))
    np.testing.assert_array_equal(p_types, types)
    np.testing.assert_array_equal(p_times, times)
    assert p_n == n_types
    want = r_events.type_index_batch(types, times, n_types, cap)
    got = p_events.type_index_batch(torch.as_tensor(types),
                                    torch.as_tensor(times), n_types, cap)
    for w, g in zip(want, got):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_union_and_aggregate_match_reference(corpus_runs):
    rng = np.random.default_rng(5)
    frontiers = [rng.integers(0, 3, (k, 3)).astype(np.int32)
                 for k in (4, 0, 7)]
    for w, g in zip(r_corpus.union_candidates(frontiers),
                    p_corpus.union_candidates(frontiers)):
        np.testing.assert_array_equal(g, w)
    _, _, _, run = corpus_runs[1]
    for m in (1, 2, 3):
        _assert_levels_equal(
            p_corpus.aggregate_min_streams(run.per_stream, m),
            r_corpus.aggregate_min_streams(run.per_stream, m), f"m={m}")
    with pytest.raises(ValueError, match="min_streams"):
        p_corpus.aggregate_min_streams([], 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_count_corpus_indexed_matches_reference(engine):
    streams = [_rand_stream(i, n, n_types=3) for i, n in
               enumerate((50, 0, 35))]
    types, times, n_types = r_corpus.pad_corpus(streams)
    tables, counts = r_events.type_index_batch(types, times, n_types, 16)
    sym = np.array([[0, 1, 2], [2, 2, 0], [1, 0, 1]], np.int32)
    lo = np.full((3, 2), 0.1, np.float32)
    hi = np.full((3, 2), 1.5, np.float32)
    thr = np.array([2, 1, 3], np.int32)
    for build_cap in (None, 12):
        want = r_counting.count_corpus_indexed(
            tables, counts, sym, lo, hi, thr, build_cap=build_cap)
        got = p_counting.count_corpus_indexed(
            *interop.type_index(tables, counts, CPU),
            *interop.candidates(sym, lo, hi, CPU),
            interop.carries(thr, thr, CPU)[1], engine=engine,
            build_cap=build_cap, device=CPU)
        for name, w, g in zip(("counts", "keep", "n_superset", "overflow"),
                              want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert got[3][0].all() and not got[3][1].any()   # stream 0 overflows 12


def test_count_corpus_matches_reference():
    rng = np.random.default_rng(6)
    times = np.sort(rng.choice(np.arange(0, 40, 0.25), (2, 3, 2, 97)),
                    axis=-1).astype(np.float32)
    times[1, 2] = np.inf
    lo = np.full((3, 1), 0.25, np.float32)
    hi = np.array([[1.0], [2.5], [0.5]], np.float32)
    want = r_ops.count_corpus(times, lo, hi, block_next=32, block_prev=32,
                              interpret=True)
    got = p_ops.count_corpus(interop.times_by_sym(times, CPU),
                             *interop.candidates(lo, lo, hi, CPU)[1:],
                             block_next=32, block_prev=32)
    for w, g in zip(want, got):
        assert g.shape == (2, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_miner_config_carries_min_streams():
    r_cfg = r_mining.MinerConfig(t_low=0.0, t_high=1.0, threshold=1,
                                 min_streams=2)
    assert _port_cfg(r_cfg, "dense").min_streams == 2

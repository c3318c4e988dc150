"""Port parity: the tracking kernels' wrappers, the ``dense_pallas`` and
fused engines' tracking entries and the tile bounds, against the JAX
reference.

On the CPU the port's wrappers (``kernels.ops.track_level``,
``track_batch``, ``track_corpus``) run their plain PyTorch versions
(``episode_track.track_level_ref``, ``track_batch_ref``). The reference
runs its Pallas kernels in interpret mode with blocks of 32
(``ops.track_level``, ``ops.track_batch``, ``ops.track_corpus``) and its
quadratic oracle ``kernels/ref.py::track_level_ref``; its engines run
through its own ``track_batch_dispatch`` / ``track_corpus_dispatch``.
Inputs come from numpy seeds; the port gets them through
``repro_torch.interop``. Tolerance 0: tracking does only f32 subtracts,
compares and max, so ``starts``, ``ends``, ``valid``, ``n_superset`` and
the ``window_tiles`` flags must be equal. On a row the reference flags as
truncated its values are unsafe while the port's are exact, so those rows
compare flags only.

The tests marked ``cuda`` run the CUDA kernels against their plain
versions; they skip without a card (``python -m pytest -m cuda
tests/test_torch_tracking.py`` on a machine with one) and need no JAX.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import tracking as p_tracking
from repro_torch.kernels import episode_track as p_et
from repro_torch.kernels import ops as p_ops

BLOCK = 32
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here rather than at the top so that the
    ``cuda`` tests also run on a machine without JAX."""
    import jax.numpy as jnp
    from repro.core import tracking
    from repro.kernels import ops
    from repro.kernels import ref as kref

    return SimpleNamespace(jnp=jnp, tracking=tracking, ops=ops, kref=kref)


def _batch(seed, b, n, cap, *, grid=False, empty=(), span=100.0):
    """Seeded [b, n, cap] sorted rows (+inf padded) and windows. ``grid``
    puts times and windows on a 0.25 grid: exact ties at window edges and
    duplicate timestamps. ``empty`` lists (row, symbol) rows left all
    padding."""
    rng = np.random.default_rng(seed)
    times = np.full((b, n, cap), np.inf, np.float32)
    for i in range(b):
        for s in range(n):
            if (i, s) in empty:
                continue
            k = int(rng.integers(0, cap + 1))
            vals = (rng.choice(np.arange(0, span, 0.25), k) if grid
                    else rng.uniform(0, span, k))
            times[i, s, :k] = np.sort(vals).astype(np.float32)
    if grid:
        lo = rng.integers(0, 3, (b, max(n - 1, 0))) * 0.25
        hi = lo + rng.integers(1, 12, (b, max(n - 1, 0))) * 0.25
    else:
        lo = rng.uniform(0, 1, (b, max(n - 1, 0)))
        hi = lo + rng.uniform(0.3, 6, (b, max(n - 1, 0)))
    return times, lo.astype(np.float32), hi.astype(np.float32)


def _t(*xs, device=CPU):
    return [interop.times_by_sym(x, device) for x in xs]


# two reference shapes per kernel ([6, 3, 130] and [5, 2, 97]), so each
# interpret-mode kernel compiles twice per test process
CASES = {
    "seeded": (0, 6, 3, 130, False, ()),
    "tie grid": (1, 5, 2, 97, True, ()),
    "cap 130 tie grid": (2, 6, 3, 130, True, {(1, 1)}),
    "cap 97 seeded": (3, 5, 2, 97, False, {(2, 0)}),
    "all-padding rows": (4, 5, 2, 97, False,
                         {(i, s) for i in range(5) for s in range(2)}),
}


# ---------------------------------------------------------------------------
# Kernel #3: one level, track_level
# ---------------------------------------------------------------------------


def _level_inputs(seed, b, n, cap, grid, empty):
    """Level 1 -> 2 of a seeded batch, with latest starts from the plain
    level 0 -> 1, so v_prev holds real -inf holes."""
    times, lo, hi = _batch(seed, b, n, cap, grid=grid, empty=empty)
    t0 = times[:, 0]
    v0 = np.where(np.isfinite(t0), t0, -np.inf).astype(np.float32)
    if n == 2:
        return t0, v0, times[:, 1], lo[:, 0], hi[:, 0]
    v1 = p_ops.track_level(*_t(t0, v0, times[:, 1], lo[:, 0], hi[:, 0]))
    return times[:, 1], v1.numpy(), times[:, 2], lo[:, 1], hi[:, 1]


@pytest.mark.parametrize("case", list(CASES))
def test_track_level_matches_reference(ref, case):
    t_prev, v_prev, t_next, lo, hi = _level_inputs(*CASES[case])
    got = p_ops.track_level(*_t(t_prev, v_prev, t_next, lo, hi)).numpy()
    jnp = ref.jnp
    for r in range(t_prev.shape[0]):
        row = [jnp.asarray(x[r]) for x in (t_prev, v_prev, t_next)]
        want = ref.ops.track_level(*row, float(lo[r]), float(hi[r]),
                                   block_next=BLOCK, block_prev=BLOCK,
                                   interpret=True)
        np.testing.assert_array_equal(got[r], np.asarray(want))
        oracle = ref.kref.track_level_ref(*row, lo[r], hi[r])
        np.testing.assert_array_equal(got[r], np.asarray(oracle))
    assert got.dtype == np.float32


def test_track_level_plain_chunks_and_leading_dims():
    t_prev, v_prev, t_next, lo, hi = _level_inputs(*CASES["seeded"])
    args = _t(t_prev, v_prev, t_next, lo, hi)
    whole = p_et.track_level_ref(*args)
    assert torch.equal(p_et.track_level_ref(*args, chunk=4), whole)
    assert torch.equal(p_et.track_level(*args, chunk=1), whole)
    # ops folds leading dims into rows and broadcasts scalar windows
    folded = p_ops.track_level(*(a.reshape(2, 3, -1) for a in args[:3]),
                               0.25, 1.5)
    flat = p_et.track_level_ref(*args[:3], torch.full((6,), 0.25),
                                torch.full((6,), 1.5))
    assert torch.equal(folded.reshape(6, -1), flat)


def test_track_episode_matches_reference(ref):
    times, lo, hi = _batch(5, 1, 3, 130, grid=True)
    want = ref.ops.track_episode(ref.jnp.asarray(times[0]), lo[0], hi[0],
                                 block_next=BLOCK, block_prev=BLOCK,
                                 interpret=True)
    got = p_ops.track_episode(*_t(times[0], lo[0], hi[0]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Kernel #2: every level of a batch, track_batch / track_corpus
# ---------------------------------------------------------------------------


def _ref_track_batch(ref, times, lo, hi, window_tiles=0, corpus=False):
    fn = ref.ops.track_corpus if corpus else ref.ops.track_batch
    out = fn(ref.jnp.asarray(times), ref.jnp.asarray(lo),
             ref.jnp.asarray(hi), block_next=BLOCK, block_prev=BLOCK,
             window_tiles=window_tiles, interpret=True)
    return [np.asarray(x) for x in out]


def _assert_flagged_same(want, got):
    """``(starts, n_superset, truncated)``: flags equal; values equal on
    the rows the reference does not flag."""
    got = [g.numpy() for g in got]
    np.testing.assert_array_equal(got[2], want[2], err_msg="truncated")
    ok = ~want[2]
    for name, w, g in zip(("starts", "n_superset"), want[:2], got[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_track_batch_matches_reference(ref, case):
    times, lo, hi = _batch(*CASES[case][:4], grid=CASES[case][4],
                           empty=CASES[case][5])
    want = _ref_track_batch(ref, times, lo, hi)
    got = p_ops.track_batch(*_t(times, lo, hi), block_next=BLOCK,
                            block_prev=BLOCK)
    assert not want[2].any()
    _assert_flagged_same(want, got)


def test_track_batch_window_tiles_flags_match_reference(ref):
    # narrow windows on some rows, wide on others: a mix of flagged rows
    times, lo, hi = _batch(6, 6, 3, 130, span=30.0)
    hi[::2] = lo[::2] + 0.05
    want = _ref_track_batch(ref, times, lo, hi, window_tiles=2)
    assert want[2].any() and not want[2].all()
    _assert_flagged_same(want, p_ops.track_batch(
        *_t(times, lo, hi), block_next=BLOCK, block_prev=BLOCK,
        window_tiles=2))


def test_track_batch_single_symbol_matches_reference(ref):
    times, lo, hi = _batch(7, 6, 1, 64, grid=True, empty={(2, 0)})
    want = _ref_track_batch(ref, times, lo, hi)
    _assert_flagged_same(want, p_ops.track_batch(*_t(times, lo, hi)))


def test_track_corpus_matches_reference(ref):
    times, lo, hi = _batch(8, 6, 3, 130, grid=True, empty={(4, 0)})
    corpus = times.reshape(2, 3, 3, 130)
    want = _ref_track_batch(ref, corpus, lo[:3], hi[:3], corpus=True)
    got = p_ops.track_corpus(*_t(corpus, lo[:3], hi[:3]))
    assert got[0].shape == (2, 3, 130)
    _assert_flagged_same(want, got)


def test_track_batch_plain_chunks_equal_whole():
    times, lo, hi = _batch(9, 6, 3, 130, grid=True)
    args = _t(times, lo, hi)
    whole = p_et.track_batch_ref(*args)
    for got in (p_et.track_batch_ref(*args, chunk=4),
                p_et.track_batch(*args, chunk=1)):
        for w, g in zip(whole, got):
            assert torch.equal(g, w)


@pytest.mark.parametrize("fn", [p_et.track_batch, p_et.track_level])
def test_track_wrappers_reject_unsupported_device(fn):
    t = torch.zeros((2, 2, 4), device="meta")
    args = ((t, t[:, 0, :1], t[:, 0, :1]) if fn is p_et.track_batch
            else (t[:, 0], t[:, 0], t[:, 0], t[:, 0, 0], t[:, 0, 0]))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*args)


# ---------------------------------------------------------------------------
# Engines: track_batch_dispatch / track_corpus_dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_case(ref):
    """One batch with narrow and wide windows, and the reference engines'
    batched and corpus dispatch of it, uncapped and capped."""
    times, lo, hi = _batch(10, 6, 3, 130, grid=True, span=40.0, empty={(3, 1)})
    hi[1::2] = lo[1::2] + 0.25
    corpus = times.reshape(2, 3, 3, 130)
    runs = {}
    for engine in ("dense_pallas", "dense_pallas_fused"):
        for wt in (0, 2):
            cfg = ref.tracking.EngineConfig(block_next=BLOCK,
                                            block_prev=BLOCK, window_tiles=wt)
            batch = ref.tracking.track_batch_dispatch(engine, times, lo, hi,
                                                      cfg)
            corp = ref.tracking.track_corpus_dispatch(engine, corpus, lo[:3],
                                                      hi[:3], cfg)
            runs[engine, wt] = ([np.asarray(x) for x in batch],
                                [np.asarray(x) for x in corp])
    return (times, lo, hi, corpus), runs


def _assert_occ_same(want, got):
    got = [g.numpy() for g in got]
    overflow = want[4]
    np.testing.assert_array_equal(got[4], overflow, err_msg="overflow")
    ok = ~overflow
    for name, w, g in zip(p_tracking.Occurrences._fields[:4], want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)


@pytest.mark.parametrize("window_tiles", [0, 2])
@pytest.mark.parametrize("engine", ["dense_pallas", "dense_pallas_fused"])
def test_engine_dispatch_matches_reference(engine_case, engine, window_tiles):
    (times, lo, hi, corpus), runs = engine_case
    want_batch, want_corpus = runs[engine, window_tiles]
    assert want_batch[4].any() == (window_tiles > 0)
    cfg = p_tracking.EngineConfig(block_next=BLOCK, block_prev=BLOCK,
                                  window_tiles=window_tiles)
    _assert_occ_same(want_batch, p_tracking.track_batch_dispatch(
        engine, *_t(times, lo, hi), cfg))
    _assert_occ_same(want_corpus, p_tracking.track_corpus_dispatch(
        engine, *_t(corpus, lo[:3], hi[:3]), cfg))


def test_engines_agree_with_dense_and_prefer_native_track_batch(monkeypatch):
    times, lo, hi = _batch(11, 6, 3, 130, grid=True)
    args = _t(times, lo, hi)
    cfg = p_tracking.EngineConfig()
    want = p_tracking.track_dense(*args)
    calls = []
    real = p_et.track_batch
    monkeypatch.setattr(p_et, "track_batch",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for engine in ("dense", "dense_pallas", "dense_pallas_fused"):
        got = p_tracking.track_batch_dispatch(engine, *args, cfg)
        for name, w, g in zip(want._fields, want, got):
            assert torch.equal(g, w), (engine, name)
    assert calls == [1]   # the fused engine's native track_batch, once


# ---------------------------------------------------------------------------
# Tile bounds and the per-level truncation flag
# ---------------------------------------------------------------------------


def test_window_bounds_and_flags_match_reference(ref):
    times, _, hi = _batch(12, 4, 3, 128, span=30.0)
    for bn, bp in ((32, 32), (16, 64)):
        want = ref.ops.required_window_tiles_batch(times, hi, bn, bp)
        assert p_ops.required_window_tiles_batch(times, hi, bn, bp) == want
        for r in range(4):
            want = ref.ops.required_window_tiles(
                times[r, 0], times[r, 1], float(hi[r, 0]), bn, bp)
            assert p_ops.required_window_tiles(
                times[r, 0], times[r, 1], float(hi[r, 0]), bn, bp) == want
        for wt in (1, 2, 3):
            want = [bool(ref.ops.window_truncated(
                times[r, 0], times[r, 1], hi[r, 0], bn, bp, wt))
                for r in range(4)]
            got = p_ops.window_truncated(*_t(times[:, 0], times[:, 1],
                                             hi[:, 0]), bn, bp, wt)
            assert got.tolist() == want


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_track_level_matches_plain_version(case):
    dev = _cuda()
    args = _t(*_level_inputs(*CASES[case]), device=dev)
    before = p_et.track_level.launches
    got = p_et.track_level(*args)
    torch.cuda.synchronize()
    assert p_et.track_level.launches == before + 1
    want = p_et.track_level_ref(*args)
    assert got.is_cuda and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_track_batch_matches_plain_version(case):
    dev = _cuda()
    seed, b, n, cap, grid, empty = CASES[case]
    args = _t(*_batch(seed, b, n + 1, cap, grid=grid, empty=empty),
              device=dev)
    before = p_et.track_batch.launches
    got = p_et.track_batch(*args)
    torch.cuda.synchronize()
    assert p_et.track_batch.launches == before + 1
    for w, g in zip(p_et.track_batch_ref(*args), got):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g, w)

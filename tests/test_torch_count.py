"""Port parity: the single-launch count pipeline and the counting layer.

The port's ``kernels.ops.count_batch`` (on the CPU: the plain PyTorch
version ``episode_track.count_batch_ref``) is held to the reference's
``kernels.ops.count_batch``, run as tests/test_count_fused.py runs it:
Pallas in interpret mode, blocks of 32. Inputs come from numpy seeds; the
port gets them through ``repro_torch.interop``. Tolerance 0: the path does
only f32 subtracts, compares, max/select and integer sums, so counts,
``end_out``, ``n_superset`` and the ``window_tiles`` truncation flags must
be equal. On a row the reference flags as truncated its count is unsafe
(the miner raises) while the port counts exactly, so those rows compare
flags only.

The one test marked ``cuda`` runs the CUDA kernel against the plain
version; it skips without a card (``python -m pytest -m cuda
tests/test_torch_count.py`` on a machine with one).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import counting as p_counting
from repro_torch.core import scheduling as p_scheduling
from repro_torch.core import tracking as p_tracking
from repro_torch.kernels import episode_track as p_et
from repro_torch.kernels import ops as p_ops

BLOCK = 32


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here rather than at the top so that the
    ``cuda`` test also runs on a machine without JAX."""
    import jax
    import jax.numpy as jnp
    from repro.core import counting, tracking
    from repro.kernels import ops

    return SimpleNamespace(jax=jax, jnp=jnp, counting=counting,
                           tracking=tracking, ops=ops)


def _batch(seed, b, n, cap, *, grid=False, empty=(), span=100.0):
    """Seeded [b, n, cap] sorted rows (+inf padded), windows and carries.
    ``grid`` puts times and windows on a 0.25 grid: exact ties at window
    edges and duplicate timestamps."""
    rng = np.random.default_rng(seed)
    times = np.full((b, n, cap), np.inf, np.float32)
    for i in range(b):
        for s in range(n):
            if (i, s) in empty:
                continue
            k = int(rng.integers(0, cap + 1))
            if grid:
                vals = rng.choice(np.arange(0, span, 0.25), k)
            else:
                vals = rng.uniform(0, span, k)
            times[i, s, :k] = np.sort(vals).astype(np.float32)
    if grid:
        lo = rng.integers(0, 3, (b, max(n - 1, 0))) * 0.25
        hi = lo + rng.integers(1, 12, (b, max(n - 1, 0))) * 0.25
    else:
        lo = rng.uniform(0, 1, (b, max(n - 1, 0)))
        hi = lo + rng.uniform(0.3, 6, (b, max(n - 1, 0)))
    pe = np.where(rng.random(b) < 0.5, -np.inf,
                  rng.uniform(0, span * 0.8, b))
    pc = rng.integers(0, 7, b)
    return (times, lo.astype(np.float32), hi.astype(np.float32),
            pe.astype(np.float32), pc.astype(np.int32))


def _reference(ref, times, lo, hi, pe, pc, window_tiles=0):
    jnp = ref.jnp
    out = ref.ops.count_batch(
        jnp.asarray(times), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(pe), jnp.asarray(pc), block_next=BLOCK, block_prev=BLOCK,
        window_tiles=window_tiles, interpret=True)
    return [np.asarray(x) for x in out]


def _port(times, lo, hi, pe, pc, window_tiles=0, chunk=8):
    out = p_ops.count_batch(
        interop.times_by_sym(times, "cpu"),
        *interop.candidates(lo, lo, hi, "cpu")[1:],
        *interop.carries(pe, pc, "cpu"), block_next=BLOCK, block_prev=BLOCK,
        window_tiles=window_tiles, chunk=chunk)
    return [x.numpy() for x in out]


def _assert_same(want, got):
    counts, end_out, nsup, truncated = want
    np.testing.assert_array_equal(got[3], truncated, err_msg="truncated")
    ok = ~truncated
    for name, w, g in zip(("counts", "end_out", "n_superset"),
                          (counts, end_out, nsup), got[:3]):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g[ok], w[ok], err_msg=name)


# ---------------------------------------------------------------------------
# ops.count_batch: port (plain version on the CPU) == reference kernel
# ---------------------------------------------------------------------------


# two reference shapes ([8, 3, 257] and [5, 2, 97]) so the interpret-mode
# kernel compiles twice per test process
@pytest.mark.parametrize("seed,b,n,cap,grid,chunk", [
    (0, 8, 3, 257, False, 8),    # odd cap: the reference pads to 288
    (1, 5, 2, 97, True, 2),      # ragged batch vs the chunk grid, 0.25 ties
    (2, 8, 3, 257, True, 3),     # tie grid, rows in passes of 3
    (3, 5, 2, 97, False, None),  # whole batch in one plain pass
])
def test_count_batch_matches_reference(ref, seed, b, n, cap, grid, chunk):
    empty = {(1, 1)} | {(b - 1, s) for s in range(n)}   # and one empty row
    case = _batch(seed, b, n, cap, grid=grid, empty=empty)
    _assert_same(_reference(ref, *case), _port(*case, chunk=chunk))


def test_count_batch_ref_equals_wrapper_on_cpu():
    case = _batch(4, 6, 3, 64, grid=True)
    want = _port(*case)
    got = p_et.count_batch_ref(
        interop.times_by_sym(case[0], "cpu"), *interop.candidates(
            case[1], case[1], case[2], "cpu")[1:],
        *interop.carries(case[3], case[4], "cpu"))
    for w, g in zip(want[:3], got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_window_tiles_truncation_flags_match_reference(ref):
    # wide windows on some rows, narrow on others: a mix of flagged rows
    times, lo, hi, pe, pc = _batch(5, 8, 3, 257, span=40.0)
    hi[::2] = lo[::2] + 0.05
    want = _reference(ref, times, lo, hi, pe, pc, window_tiles=3)
    assert want[3].any() and not want[3].all()
    _assert_same(want, _port(times, lo, hi, pe, pc, window_tiles=3))


def test_single_symbol_point_intervals_match_reference(ref):
    case = _batch(6, 8, 1, 64, grid=True, empty={(2, 0)})
    _assert_same(_reference(ref, *case), _port(*case))


def test_all_padding_rows_pass_carries_through(ref):
    times, lo, hi, pe, pc = _batch(7, 5, 2, 97, empty={
        (i, s) for i in range(5) for s in range(2)})
    counts, end_out, nsup, truncated = _port(times, lo, hi, pe, pc)
    np.testing.assert_array_equal(counts, pc)
    np.testing.assert_array_equal(end_out, pe)
    assert not nsup.any() and not truncated.any()
    _assert_same(_reference(ref, times, lo, hi, pe, pc),
                 [counts, end_out, nsup, truncated])


def test_stream_axis_folds_like_reference(ref):
    times, lo, hi, pe, pc = _batch(8, 8, 3, 257, grid=True)
    fold = lambda x: x.reshape((2, 4) + x.shape[1:])   # noqa: E731
    want = _reference(ref, *(fold(x) for x in (times, lo, hi, pe, pc)))
    got = _port(*(fold(x) for x in (times, lo, hi, pe, pc)))
    for w, g in zip(want, got):
        assert g.shape == (2, 4)
        np.testing.assert_array_equal(g, w)


def test_window_scan_table_matches_reference(ref):
    times, _, hi, _, _ = _batch(9, 4, 3, 64)
    for wt in (0, 1, 2):
        want = ref.ops.window_scan_table(
            ref.jnp.asarray(times), ref.jnp.asarray(hi), 8, 16, wt)
        got = p_ops.window_scan_table(interop.times_by_sym(times, "cpu"),
                                      interop.times_by_sym(hi, "cpu"), 8, 16,
                                      wt)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert p_ops.tile_geometry(130, 32, 48) == ref.ops.tile_geometry(130, 32, 48)


def test_count_batch_rejects_unsupported_device():
    t = torch.zeros((2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        p_et.count_batch(t, t[:, 0, :1], t[:, 0, :1], t[:, 0, 0],
                         t[:, 0, 0].int())


# ---------------------------------------------------------------------------
# Counting layer: dense tracking, the greedy schedulers, the dispatch
# ---------------------------------------------------------------------------


def test_track_dense_matches_reference(ref):
    times, lo, hi, _, _ = _batch(10, 5, 4, 48, grid=True)
    occ_ref = ref.jax.jit(ref.jax.vmap(ref.tracking.track_dense))(times, lo, hi)
    want = [[np.asarray(x[i]) for x in occ_ref] for i in range(len(times))]
    occ = p_tracking.track_dense(*(interop.times_by_sym(x, "cpu")
                                   for x in (times, lo, hi)))
    for i, w in enumerate(want):
        for name, wv, gv in zip(occ._fields, w, occ):
            np.testing.assert_array_equal(gv[i].numpy(), wv, err_msg=name)


@pytest.mark.parametrize("parallel", [False, True])
def test_schedulers_match_reference(ref, parallel):
    rng = np.random.default_rng(11)
    b, cap = 6, 40
    ends = np.sort(rng.choice(np.arange(0, 30, 0.5), (b, cap)), axis=1)
    starts = ends - rng.choice([0.0, 0.5, 1.0, 2.5], (b, cap))
    valid = rng.random((b, cap)) < 0.7
    starts = np.where(valid, starts, -np.inf).astype(np.float32)
    ends = np.where(valid, ends, np.inf).astype(np.float32)
    pe = np.where(rng.random(b) < 0.5, -np.inf, 4.0).astype(np.float32)
    pc = rng.integers(0, 3, b).astype(np.int32)
    occ = p_tracking.Occurrences(
        torch.as_tensor(starts), torch.as_tensor(ends),
        torch.as_tensor(valid), None, None)
    got_e, got_c = p_scheduling.greedy_state(
        occ, *interop.carries(pe, pc, "cpu"), parallel=parallel)
    want_e, want_c = ref.jax.jit(
        ref.counting._greedy_batch_state, static_argnums=3)(
        ref.tracking.Occurrences(starts, ends, valid, None, None), pe, pc,
        parallel)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.fixture(scope="module")
def dispatch_case(ref):
    """One carried batch and the reference's dense dispatch of it (both
    reference schedulers give the same bits, tests/test_count_fused.py)."""
    times, lo, hi, pe, pc = _batch(12, 5, 3, 64, grid=True)
    dispatch = ref.jax.jit(ref.counting.count_batch_dispatch,
                           static_argnums=(0, 6))
    want = dispatch("dense", times, lo, hi, pe, pc,
                    ref.tracking.EngineConfig())
    return (times, lo, hi, pe, pc), [np.asarray(w) for w in want]


@pytest.mark.parametrize("engine", ["dense", "dense_pallas_fused"])
@pytest.mark.parametrize("parallel_schedule", [False, True])
def test_count_batch_dispatch_matches_reference(dispatch_case, engine,
                                                parallel_schedule):
    (times, lo, hi, pe, pc), want = dispatch_case
    got = p_counting.count_batch_dispatch(
        engine, *(interop.times_by_sym(x, "cpu") for x in (times, lo, hi)),
        *interop.carries(pe, pc, "cpu"), p_tracking.EngineConfig(),
        parallel_schedule=parallel_schedule)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_fused_engine_track_names_its_slice():
    """The fused engine's tracking entries are the port of
    track_batch_pallas (tests/test_torch_tracking.py holds them to the
    reference); here: they run, and give the plain tracking."""
    times, lo, hi, _, _ = _batch(13, 4, 3, 64, grid=True)
    t, lo, hi = (interop.times_by_sym(x, "cpu") for x in (times, lo, hi))
    eng = p_tracking.get_engine("dense_pallas_fused")
    cfg = p_tracking.EngineConfig()
    want = p_tracking.track_dense(t, lo, hi)
    got = [eng.track(t, lo, hi, cfg), eng.track_batch(t, lo, hi, cfg),
           eng.track_corpus(t[None], lo, hi, cfg)]
    for occ in got:
        for name, w, g in zip(want._fields, want, occ):
            assert torch.equal(g.reshape(w.shape), w), name


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed,b,n,cap,grid", [
    (20, 8, 3, 257, False), (21, 37, 2, 97, True), (22, 16, 5, 130, True)])
def test_cuda_kernel_matches_plain_version(seed, b, n, cap, grid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    times, lo, hi, pe, pc = _batch(seed, b, n, cap, grid=grid,
                                   empty={(1, 1)})
    args = [interop.times_by_sym(times, "cuda"),
            *interop.candidates(lo, lo, hi, "cuda")[1:],
            *interop.carries(pe, pc, "cuda")]
    before = p_et.count_batch.launches
    got = p_et.count_batch(*args)
    torch.cuda.synchronize()
    assert p_et.count_batch.launches == before + 1
    want = p_et.count_batch_ref(*args)
    for w, g in zip(want, got):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g, w)

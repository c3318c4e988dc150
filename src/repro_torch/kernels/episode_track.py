"""The tracking kernels: wrappers around the Hopper kernels in ``csrc/``.

Each computes the dense tracking recurrence (windowed max of latest-start
values, ``t - hi <= s < t - lo`` in f32) and differs in what it emits:

* :func:`count_batch` (``csrc/count_batch.cu``, the port of the
  reference's ``kernels/episode_track.py::count_batch_pallas``): every
  level of a ``[B, N, cap]`` candidate batch, the paper's §IV-D
  compaction of the valid ``(start, end)`` intervals and the strict greedy
  fold seeded by the ``(prev_end, count)`` carry; only ``counts i32[B]``,
  ``end_out f32[B]`` and ``n_superset i32[B]`` leave the kernel.
* :func:`track_batch` (``csrc/track_batch.cu``, port of
  ``track_batch_pallas``): every level of a ``[B, N, cap]`` batch; the
  final level's latest starts ``f32[B, cap]`` and ``n_superset i32[B]``.
* :func:`track_level` (``csrc/track_level.cu``, port of
  ``track_level_pallas``): one level for ``R`` rows, ``v_next f32[R, cap]``
  from ``t_prev, v_prev, t_next f32[R, cap]`` and per-row windows.

On a CPU tensor a wrapper runs its plain PyTorch version (``*_ref``); on a
CUDA tensor it launches its kernel or raises. Each wrapper's ``launches``
attribute counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG = float("-inf")
INF = float("inf")

#: thread blocks per SM the grids are sized for (every kernel's blocks are
#: _THREADS threads, compiled to fit this many on a SM: kBlocksPerSm in
#: csrc/track_common.cuh; the grids stride over the work beyond this)
_BLOCKS_PER_SM = 8
_THREADS = 256


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _count_rows(times_by_sym, t_low, t_high, prev_end, prev_count):
    from ..core.tracking import track_dense  # deferred: core imports kernels

    occ = track_dense(times_by_sym, t_low, t_high)
    batch, cap = occ.valid.shape
    # §IV-D compaction: prefix-scan the keep flags; the k-th kept interval
    # sits at searchsorted(csum, k+1) (the scatter-write as a gather)
    csum = occ.valid.to(torch.int64).cumsum(dim=1)
    targets = torch.arange(1, cap + 1, device=csum.device).expand(batch, cap)
    src = torch.searchsorted(csum, targets.contiguous(), side="left")
    live = src < cap
    src_c = src.clamp(max=cap - 1)
    s = torch.where(live, torch.gather(occ.starts, 1, src_c), NEG)
    e = torch.where(live, torch.gather(occ.ends, 1, src_c), INF)
    m = csum[:, -1]
    # greedy fold (take iff start > prev_end, strict) over the compacted
    # prefix only: max(m) steps instead of cap
    prev_e = prev_end.clone()
    cnt = torch.zeros_like(prev_count)
    for j in range(int(m.max()) if batch else 0):
        take = (j < m) & (s[:, j] > prev_e)
        prev_e = torch.where(take, e[:, j], prev_e)
        cnt = cnt + take.to(torch.int32)
    return prev_count + cnt, prev_e, occ.n_superset


def count_batch_ref(
    times_by_sym: torch.Tensor,   # f32[B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,          # f32[B, N-1]
    t_high: torch.Tensor,         # f32[B, N-1]
    prev_end: torch.Tensor,       # f32[B] carried greedy prev_end
    prev_count: torch.Tensor,     # i32[B] carried greedy count
    *,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: dense tracking
    with a sparse-table range max, compaction by prefix scan, the greedy
    fold as a loop. ``chunk`` rows go through at a time (all by default):
    the sparse table takes ``log2(cap)`` copies of a chunk's rows.
    Returns ``(counts i32[B], end_out f32[B], n_superset i32[B])``."""
    batch = times_by_sym.shape[0]
    if batch == 0:
        dev = times_by_sym.device
        zi = torch.zeros(0, dtype=torch.int32, device=dev)
        return zi, torch.zeros(0, dtype=torch.float32, device=dev), zi
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 rows, got {chunk}")
    step = batch if chunk is None else chunk
    parts = [
        _count_rows(times_by_sym[i:i + step], t_low[i:i + step],
                    t_high[i:i + step], prev_end[i:i + step],
                    prev_count[i:i + step])
        for i in range(0, batch, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _launch(name: str, n_ptr: int, n_int: int, *args) -> None:
    """Call ``repro_<name>`` of ``csrc/<name>.cu`` (``n_ptr`` pointers,
    ``n_int`` ints, then the stream) and raise if the launch failed."""
    _build.call(name, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                + [ctypes.c_void_p], *args)


def _grid_rows(device, rows: int) -> int:
    """Blocks for a kernel that runs one block per row (grid-stride)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(rows, sms * _BLOCKS_PER_SM)


def _device_of(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {x.device}")
    return x.device.type == "cuda"


def _check_table(times_by_sym, t_low, t_high):
    """Checks of the ``[B, N, cap]`` table and its windows every batched
    kernel takes; returns ``(B, N, cap)``."""
    if times_by_sym.dim() != 3 or times_by_sym.shape[1] < 2:
        raise ValueError("times_by_sym must be [B, N, cap] with N >= 2, got "
                         f"{tuple(times_by_sym.shape)}")
    batch, n, cap = times_by_sym.shape
    if cap < 1 or max(batch, cap) >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= cap and batch, cap < 2**31, "
                         f"got batch {batch}, cap {cap}")
    device = times_by_sym.device
    _check("times_by_sym", times_by_sym, torch.float32, (batch, n, cap), device)
    _check("t_low", t_low, torch.float32, (batch, n - 1), device)
    _check("t_high", t_high, torch.float32, (batch, n - 1), device)
    return batch, n, cap


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, times_by_sym on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count_batch(
    times_by_sym: torch.Tensor,   # f32[B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,          # f32[B, N-1]
    t_high: torch.Tensor,         # f32[B, N-1]
    prev_end: torch.Tensor,       # f32[B]
    prev_count: torch.Tensor,     # i32[B]
    *,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-batch tracking + compaction + greedy counting, ONE launch.

    Returns ``(counts i32[B], end_out f32[B], n_superset i32[B])`` with the
    ``prev_count`` carry-in included in ``counts`` and ``end_out`` the
    carried-out greedy state (``prev_end`` where nothing is taken). Every
    constraint window is scanned exactly: the reference's ``window_tiles``
    cap and its truncation flag live in ``ops.count_batch``, and on a
    flagged row this kernel returns the exact count where the reference's
    is documented as unsafe.

    CPU tensors go to :func:`count_batch_ref` (``chunk`` rows at a time);
    CUDA tensors launch the kernel on the current stream.
    """
    if not _device_of("count_batch", times_by_sym):
        return count_batch_ref(times_by_sym, t_low, t_high, prev_end,
                               prev_count, chunk=chunk)
    device = times_by_sym.device
    batch, n, cap = _check_table(times_by_sym, t_low, t_high)
    _check("prev_end", prev_end, torch.float32, (batch,), device)
    _check("prev_count", prev_count, torch.int32, (batch,), device)
    counts = torch.empty(batch, dtype=torch.int32, device=device)
    end_out = torch.empty(batch, dtype=torch.float32, device=device)
    nsup = torch.empty(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return counts, end_out, nsup
    with torch.cuda.device(device):
        grid = _grid_rows(device, batch)
        # latest-start ping-pong rows, one pair per block, reused across the
        # rows a block strides over
        scratch = torch.empty((grid, 2, cap), dtype=torch.float32,
                              device=device)
        _launch("count_batch", 9, 4,
                times_by_sym.data_ptr(), t_low.data_ptr(), t_high.data_ptr(),
                prev_end.data_ptr(), prev_count.data_ptr(), counts.data_ptr(),
                end_out.data_ptr(), nsup.data_ptr(), scratch.data_ptr(),
                batch, n, cap, grid,
                torch.cuda.current_stream(device).cuda_stream)
    count_batch.launches += 1
    return counts, end_out, nsup


count_batch.launches = 0


# ---------------------------------------------------------------------------
# Batched multi-level tracking: track_batch
# ---------------------------------------------------------------------------


def track_batch_ref(
    times_by_sym: torch.Tensor,   # f32[B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,          # f32[B, N-1]
    t_high: torch.Tensor,         # f32[B, N-1]
    *,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the track_batch kernel, on any device: dense
    tracking with a sparse-table range max, ``chunk`` rows at a time (all by
    default). Returns ``(starts f32[B, cap], n_superset i32[B])``."""
    from ..core.tracking import track_dense  # deferred: core imports kernels

    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 rows, got {chunk}")
    batch, _, cap = times_by_sym.shape
    if batch == 0:
        return (times_by_sym.new_empty((0, cap)),
                torch.zeros(0, dtype=torch.int32, device=times_by_sym.device))
    step = batch if chunk is None else chunk
    parts = [track_dense(times_by_sym[i:i + step], t_low[i:i + step],
                         t_high[i:i + step])
             for i in range(0, batch, step)]
    return (torch.cat([p.starts for p in parts]),
            torch.cat([p.n_superset for p in parts]))


def track_batch(
    times_by_sym: torch.Tensor,   # f32[B, N, cap] sorted rows, +inf padded
    t_low: torch.Tensor,          # f32[B, N-1]
    t_high: torch.Tensor,         # f32[B, N-1]
    *,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every tracking level of a whole candidate batch, ONE launch.

    Returns ``(starts f32[B, cap], n_superset i32[B])``: the final level's
    latest starts (-inf where no occurrence reaches the event; not masked
    for end validity) and the tracked superset size. Every window is
    scanned exactly. CPU tensors go to :func:`track_batch_ref` (``chunk``
    rows at a time); CUDA tensors launch the kernel on the current stream.
    """
    if not _device_of("track_batch", times_by_sym):
        return track_batch_ref(times_by_sym, t_low, t_high, chunk=chunk)
    device = times_by_sym.device
    batch, n, cap = _check_table(times_by_sym, t_low, t_high)
    starts = torch.empty((batch, cap), dtype=torch.float32, device=device)
    nsup = torch.empty(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return starts, nsup
    with torch.cuda.device(device):
        grid = _grid_rows(device, batch)
        # one latest-start row per block for the levels between the first
        # and the last (the other ping-pong buffer is the output row)
        scratch = torch.empty((grid, cap), dtype=torch.float32, device=device)
        _launch("track_batch", 6, 4,
                times_by_sym.data_ptr(), t_low.data_ptr(), t_high.data_ptr(),
                starts.data_ptr(), nsup.data_ptr(), scratch.data_ptr(),
                batch, n, cap, grid,
                torch.cuda.current_stream(device).cuda_stream)
    track_batch.launches += 1
    return starts, nsup


track_batch.launches = 0


# ---------------------------------------------------------------------------
# One tracking level for a batch of rows: track_level
# ---------------------------------------------------------------------------


def track_level_ref(
    t_prev: torch.Tensor,   # f32[R, cap] sorted rows, +inf padded
    v_prev: torch.Tensor,   # f32[R, cap] latest starts, -inf padded
    t_next: torch.Tensor,   # f32[R, cap] sorted rows, +inf padded
    t_low: torch.Tensor,    # f32[R]
    t_high: torch.Tensor,   # f32[R]
    *,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the track_level kernel, on any device: a
    sparse-table range max over each window's index range (exact: the
    edges are the same f32 subtracts and compares), ``chunk`` rows at a
    time (all by default). Returns ``v_next f32[R, cap]``."""
    from ..core.tracking import window_max  # deferred: core imports kernels

    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 rows, got {chunk}")
    rows = t_prev.shape[0]
    if rows == 0:
        return t_prev.new_empty(t_prev.shape)
    step = rows if chunk is None else chunk
    return torch.cat([
        window_max(t_prev[i:i + step], v_prev[i:i + step],
                   t_next[i:i + step], t_low[i:i + step, None],
                   t_high[i:i + step, None])
        for i in range(0, rows, step)])


def track_level(
    t_prev: torch.Tensor,   # f32[R, cap] sorted rows, +inf padded
    v_prev: torch.Tensor,   # f32[R, cap] latest starts, -inf padded
    t_next: torch.Tensor,   # f32[R, cap] sorted rows, +inf padded
    t_low: torch.Tensor,    # f32[R]
    t_high: torch.Tensor,   # f32[R]
    *,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """One tracking level for ``R`` rows, ONE launch: ``v_next[r, i]`` is
    the max of ``v_prev[r, j]`` over ``t_next[r, i] - t_high[r] <=
    t_prev[r, j] < t_next[r, i] - t_low[r]``, -inf where that window is
    empty or ``t_next[r, i]`` is not finite. Every window is scanned
    exactly. CPU tensors go to :func:`track_level_ref`; CUDA tensors launch
    the kernel on the current stream."""
    if not _device_of("track_level", t_prev):
        return track_level_ref(t_prev, v_prev, t_next, t_low, t_high,
                               chunk=chunk)
    device = t_prev.device
    if t_prev.dim() != 2:
        raise ValueError(f"t_prev must be [R, cap], got {tuple(t_prev.shape)}")
    rows, cap = t_prev.shape
    if cap < 1 or max(rows, cap) >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= cap and rows, cap < 2**31, "
                         f"got rows {rows}, cap {cap}")
    for name, x in (("t_prev", t_prev), ("v_prev", v_prev),
                    ("t_next", t_next)):
        _check(name, x, torch.float32, (rows, cap), device)
    _check("t_low", t_low, torch.float32, (rows,), device)
    _check("t_high", t_high, torch.float32, (rows,), device)
    v_next = torch.empty((rows, cap), dtype=torch.float32, device=device)
    if rows == 0:
        return v_next
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # one thread per next event, grid-stride over all R * cap of them
        grid = min(-(-rows * cap // _THREADS), sms * _BLOCKS_PER_SM)
        _launch("track_level", 6, 3,
                t_prev.data_ptr(), v_prev.data_ptr(), t_next.data_ptr(),
                t_low.data_ptr(), t_high.data_ptr(), v_next.data_ptr(),
                rows, cap, grid, torch.cuda.current_stream(device).cuda_stream)
    track_level.launches += 1
    return v_next


track_level.launches = 0

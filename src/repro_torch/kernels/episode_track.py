"""The single-launch count pipeline: tracking + compaction + greedy.

:func:`count_batch` is the wrapper around the Hopper kernel
``csrc/count_batch.cu`` (the port of the reference's
``kernels/episode_track.py::count_batch_pallas``). For every candidate row
of a ``[B, N, cap]`` symbol-time table it runs the dense tracking
recurrence (windowed max of latest-start values, ``t - hi <= s < t - lo``
in f32), the paper's §IV-D compaction of the valid ``(start, end)``
intervals and the strict greedy fold seeded by the ``(prev_end, count)``
carry, and returns only ``counts i32[B]``, ``end_out f32[B]`` and
``n_superset i32[B]``.

On a CPU tensor the wrapper runs :func:`count_batch_ref`, the plain
PyTorch version of the same function; on a CUDA tensor it launches the
kernel or raises. ``count_batch.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

NEG = float("-inf")
INF = float("inf")

#: thread blocks per SM the grid is sized for (the kernel's blocks are
#: 256 threads; the grid strides over rows beyond this)
_BLOCKS_PER_SM = 8


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


def _library() -> ctypes.CDLL:
    lib = _build.load("count_batch")
    fn = lib.repro_count_batch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    device = times_by_sym.device
    if device.type == "cpu":
        return count_batch_ref(times_by_sym, t_low, t_high, prev_end,
                               prev_count, chunk=chunk)
    if device.type != "cuda":
        raise ValueError(f"count_batch runs on CUDA or CPU tensors, got {device}")
    if times_by_sym.dim() != 3 or times_by_sym.shape[1] < 2:
        raise ValueError("times_by_sym must be [B, N, cap] with N >= 2, got "
                         f"{tuple(times_by_sym.shape)}")
    batch, n, cap = times_by_sym.shape
    if cap < 1 or max(batch, cap) >= 2 ** 31:
        raise ValueError(f"the kernel takes 1 <= cap and batch, cap < 2**31, "
                         f"got batch {batch}, cap {cap}")
    _check("times_by_sym", times_by_sym, torch.float32, (batch, n, cap), device)
    _check("t_low", t_low, torch.float32, (batch, n - 1), device)
    _check("t_high", t_high, torch.float32, (batch, n - 1), device)
    _check("prev_end", prev_end, torch.float32, (batch,), device)
    _check("prev_count", prev_count, torch.int32, (batch,), device)
    counts = torch.empty(batch, dtype=torch.int32, device=device)
    end_out = torch.empty(batch, dtype=torch.float32, device=device)
    nsup = torch.empty(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return counts, end_out, nsup
    lib = _library()
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = min(batch, sms * _BLOCKS_PER_SM)
        # latest-start ping-pong rows, one pair per block, reused across the
        # rows a block strides over
        scratch = torch.empty((grid, 2, cap), dtype=torch.float32,
                              device=device)
        err = lib.repro_count_batch(
            times_by_sym.data_ptr(), t_low.data_ptr(), t_high.data_ptr(),
            prev_end.data_ptr(), prev_count.data_ptr(), counts.data_ptr(),
            end_out.data_ptr(), nsup.data_ptr(), scratch.data_ptr(),
            batch, n, cap, grid, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "count_batch kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} ({err})")
    count_batch.launches += 1
    return counts, end_out, nsup


count_batch.launches = 0

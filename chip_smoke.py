#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the card's name and power limit, as ``nvidia-smi`` reports them; the
   five CUDA kernels built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and ``nvcc``'s register and spill
   report for each compiled function;
2. kernel vs plain: each tracking kernel (``count_batch``, ``track_batch``,
   ``track_level``) against its plain PyTorch version on the card, bit for
   bit, on seeded batches, a 0.25 tie grid, all-padding rows, odd
   capacities and the real level-2 batch of phase 3; ``flash_attention``
   (bf16 causal at qwen3-0.6b's prefill shape ``[4, 4096, 16 q / 8 kv
   heads, 128]`` and f32 at the same shape, f32 and non-causal cases, a
   ragged sequence) within f32 2e-3 / bf16 3e-2 and ``wkv_chunk`` (f32 at rwkv6-3b's ``[4, 4096,
   40, 64]``, chunk 32, and sequences that shrink the chunk to 21 and 1)
   within 2e-4 scaled by ``max(1, max|plain|)``, the tolerances of
   tests/test_kernels.py;
3. the main path: level-wise mining of the paper's Table II dataset 3
   (64 neurons, 1000 s, about 1.43M spikes) to level 5 with
   ``engine="dense_pallas_fused"``: one count launch per counted level,
   embedded cascades recovered, a sample of mined counts equal to the FSM
   oracle, and the whole result equal to ``engine="dense"`` on the card;
   then the other paths, each with the launch counts set to 0 just before
   it and read just after:
   - the same mine with ``engine="dense_pallas"``: one track_level launch
     per tracking level (sum of level - 1), equal to the fused result;
   - the tracking entry ``track_batch_dispatch("dense_pallas_fused")`` on
     the level-2 batch: one track_batch launch, equal to ``track_dense``,
     and its greedy counts equal to the count kernel's;
   - ``mine_corpus`` of four Table II dataset 4 recordings (500 s each,
     network seeds 0-3) with ``dense_pallas_fused``: one count launch per
     counted level for the whole corpus, every stream equal to its own
     ``mine_arrays``, the ">= 2 streams" aggregate; then the same corpus
     with ``dense_pallas``, equal;
   - LM serving at full width with seeded random weights, qwen3-0.6b and
     then rwkv6-3b: ``make_prefill_step`` on 4 prompts of 4096 tokens
     (one flash launch per layer, 28; one WKV launch per layer, 32),
     last-position logits finite; layer by layer, each layer on the input
     the layers before it give it: its prefill output with the kernel
     within ``LAYER_TOL`` of the same with the plain version, and its 64
     decode steps within ``LAYER_TOL`` of its forward; the whole model:
     the prefill logits with the kernel against those with the plain
     version and 64 teacher-forced decode steps against ``Model.forward``,
     each within twice a control on the same logits (the largest change
     that 1e-6 relative perturbations, before the bf16 rounding, of what
     the two runs round differently make); ``launch.serve.main`` answering
     every request (qwen3: 16 of 32 tokens on 8 slots; rwkv6: 8 of 16 on
     4), called twice;
4. times: each kernel at its main-path shape (CUDA events) beside its
   bound, its plain version's time and, for flash attention,
   ``scaled_dot_product_attention``'s; the wall time of the mine and of
   each prefill (first and second call), the serve loops' tokens/s (first
   and second call), peak memory;
5. one more (warm) fused mine on the host clock, and one under
   torch.profiler: device time by kernel and the device's busy share; the
   same for eight warm serve steps of each language model (run in phase
   3, while its model is loaded).

Prints one JSON line of kernel measurements and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a card or without the repository's ``src/`` beside it.
"""
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import corpus, counting, tracking  # noqa: E402
from repro_torch.core import events as events_lib  # noqa: E402
from repro_torch.core import mining, plan, statemachine  # noqa: E402
from repro_torch.core.episodes import Episode  # noqa: E402
from repro_torch.core.tracking import track_dense  # noqa: E402
from repro_torch.data import spikes  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import _build, episode_track  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import wkv_chunk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, layers  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 ops/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
DEVICE = "cuda"
DATASET = 3                  # paper Table II: 1000 s of simulated time
SCALE = 1.0                  # of the dataset's duration: the full dataset
MAX_LEVEL = 5
# 2**-7 s: the windows of examples/neuroscience_mining.py are 2 * 5 ms;
# this one is exactly representable in float32, so t - hi is exact and the
# float32 kernel and the float64 FSM oracle decide every window edge alike
T_HIGH = 2.0 ** -7
PLAIN_CHUNK = 1024           # rows per pass of the plain version at level 2
CORPUS_DATASET = 4           # paper Table II: 500 s of simulated time
CORPUS_SEEDS = (0, 1, 2, 3)  # one recording per network seed
#: LM serving: the configs' full width (False: ``reduced()``, for a
#: rehearsal on the CPU), prompts of PREFILL_SEQ tokens, PREFILL_BATCH of
#: them, and the teacher-forced decode check's batch and length
LM_FULL_WIDTH = True
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
DECODE_BATCH, DECODE_LEN = 2, 64
#: the serve loops: (slots, cache length, requests, new tokens each)
SERVE = {"qwen3-0.6b": (8, 1024, 16, 32), "rwkv6-3b": (4, 256, 8, 16)}
#: tests/test_models.py's decode-vs-forward bound (rtol = atol = 0.05), set
#: at 2 layers; printed beside the whole-model comparisons, which hold
#: CONTROL_FACTOR x their control instead (see whole_model_checks)
LM_TOL = 0.05
#: the whole-model controls: perturbations of rounding size (1e-6
#: relative, in f32 before the bf16 rounding), CONTROL_DRAWS draws, and the
#: bound CONTROL_FACTOR x the largest difference they make
CONTROL_REL, CONTROL_DRAWS, CONTROL_FACTOR = 1e-6, 3, 2.0
TRACE_STEPS = 8   # serve steps timed and profiled in phase 5
#: one layer's output on the same input (kernel vs plain, decode vs
#: forward): about two bf16 ulps of the largest entry
LAYER_TOL = 2e-2
#: the kernels, their wrappers and the TPU kernels they replace
KERNELS = {
    "count_batch": (episode_track.count_batch,
                    "src/repro/kernels/episode_track.py:382"),
    "track_batch": (episode_track.track_batch,
                    "src/repro/kernels/episode_track.py:213"),
    "track_level": (episode_track.track_level,
                    "src/repro/kernels/episode_track.py:89"),
    "flash_attention": (fa.flash_attention,
                        "src/repro/kernels/flash_attention.py:81"),
    "wkv_chunk": (wkv_chunk.wkv_chunked, "src/repro/kernels/wkv_chunk.py:64"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain
# ---------------------------------------------------------------------------


def seeded_batch(seed, b, n, cap, *, grid=False, empty=(), span=100.0):
    """[b, n, cap] sorted rows (+inf padded), windows and carries."""
    rng = np.random.default_rng(seed)
    times = np.full((b, n, cap), np.inf, np.float32)
    for i in range(b):
        for s in range(n):
            if (i, s) in empty:
                continue
            k = int(rng.integers(0, cap + 1))
            vals = (rng.choice(np.arange(0, span, 0.25), k) if grid
                    else rng.uniform(0, span, k))
            times[i, s, :k] = np.sort(vals)
    if grid:
        lo = rng.integers(0, 3, (b, n - 1)) * 0.25
        hi = lo + rng.integers(1, 12, (b, n - 1)) * 0.25
    else:
        lo = rng.uniform(0, 1, (b, n - 1))
        hi = lo + rng.uniform(0.3, 6, (b, n - 1))
    pe = np.where(rng.random(b) < 0.5, -np.inf, rng.uniform(0, span, b))
    pc = rng.integers(0, 7, b)
    return (torch.tensor(times, device=DEVICE),
            torch.tensor(lo, dtype=torch.float32, device=DEVICE),
            torch.tensor(hi, dtype=torch.float32, device=DEVICE),
            torch.tensor(pe, dtype=torch.float32, device=DEVICE),
            torch.tensor(pc, dtype=torch.int32, device=DEVICE))


def ptxas_summary(build_log: str) -> list:
    """One line per compiled function of ``nvcc -Xptxas -v``'s report: its
    (mangled) kernel name and template arguments, registers, spills and
    shared memory."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+kernel)(I\w*?E)?E", m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
            continue
        if "spill stores" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def max_abs_err(want, got) -> float:
    """Largest |kernel - plain| over the three outputs (0 where both are
    the same infinity)."""
    err = 0.0
    for w, g in zip(want, got):
        w, g = w.double(), g.double()
        same = (w == g)
        diff = torch.where(same, torch.zeros_like(w), (w - g).abs())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def kernel_vs_plain(kernel, name, args, chunk=None) -> float:
    """One kernel against its plain version on the same inputs; raises
    unless every output is equal, returns the largest difference."""
    wrapper = KERNELS[kernel][0]
    got = wrapper(*args)
    torch.cuda.synchronize()
    want = getattr(episode_track, f"{kernel}_ref")(*args, chunk=chunk)
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max_abs_err(want, got)
    for i, (w, g) in enumerate(zip(want, got)):
        if w.dtype != g.dtype or not torch.equal(w, g):
            bad = int((w != g).sum())
            raise AssertionError(
                f"{kernel} kernel != plain on {name}: output {i} differs in "
                f"{bad} entries")
    log(f"  {kernel} {name}: shape {tuple(args[0].shape)} kernel == plain, "
        f"max_abs_err {err}")
    return err


def level_rows(times, lo, hi, chunk=None):
    """The last level transition of a ``[B, N, cap]`` batch as the
    ``[R, cap]`` rows track_level takes, its latest starts from the plain
    version of the levels before it."""
    t0 = times[:, 0]
    v = torch.where(torch.isfinite(t0), t0, float("-inf"))
    n = times.shape[1]
    for i in range(n - 2):
        v = episode_track.track_level_ref(times[:, i], v, times[:, i + 1],
                                          lo[:, i], hi[:, i], chunk=chunk)
    return (times[:, n - 2].contiguous(), v.contiguous(),
            times[:, n - 1].contiguous(), lo[:, n - 2].contiguous(),
            hi[:, n - 2].contiguous())


def all_kernels_vs_plain(name, batch, chunk=None):
    """Phase 2 on one seeded batch: each kernel on its view of it."""
    times, lo, hi = batch[:3]
    return [kernel_vs_plain("count_batch", name, batch, chunk),
            kernel_vs_plain("track_batch", name, (times, lo, hi), chunk),
            kernel_vs_plain("track_level", name,
                            level_rows(times, lo, hi, chunk), chunk)]


def reset_launches() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, (wrapper, _) in KERNELS.items()}


def expect_launches(path: str, got: dict, want: dict) -> None:
    """Raise unless this path launched exactly ``want`` of each kernel
    (0 for a kernel it does not name)."""
    full = {name: want.get(name, 0) for name in KERNELS}
    log(f"  launches on {path}: {got} (expected {full})")
    if got != full or not any(full.values()):
        raise AssertionError(f"{path}: launches {got}, expected {full}")


# ---------------------------------------------------------------------------
# Phase 3 helpers
# ---------------------------------------------------------------------------


def level2_batch(stream, cap):
    """The level-2 batch mine_arrays counts: every ordered pair of the
    frequent types, gathered from the capacity-class-padded index."""
    table, counts = events_lib.type_index(
        stream.types.to(DEVICE), stream.times.to(DEVICE), stream.n_types, cap)
    width = plan.capacity_class(cap)
    table = plan.pad_width(table, width, float("inf"))
    types = np.arange(stream.n_types, dtype=np.int32)
    sym = np.stack([np.repeat(types, types.size), np.tile(types, types.size)], 1)
    b = sym.shape[0]
    times = table[torch.as_tensor(sym, device=DEVICE).long()].contiguous()
    lo = torch.zeros((b, 1), dtype=torch.float32, device=DEVICE)
    hi = torch.full((b, 1), T_HIGH, dtype=torch.float32, device=DEVICE)
    pe = torch.full((b,), float("-inf"), dtype=torch.float32, device=DEVICE)
    pc = torch.zeros(b, dtype=torch.int32, device=DEVICE)
    return times, lo, hi, pe, pc


def needed_operations(times, t_low, t_high, m_total) -> int:
    """Compares and maxes this batch's data needs: per level, a merge of
    the sorted prev and next rows for each of the two window edges, one max
    per (next event, prev event in its window) pair, and one greedy compare
    per compacted interval."""
    ops = int(m_total)
    n = times.shape[1]
    for lv in range(n - 1):
        tp, tn = times[:, lv].contiguous(), times[:, lv + 1]
        fin_p = torch.isfinite(tp).sum()
        fin_n = torch.isfinite(tn)
        lo = torch.searchsorted(tp, (tn - t_high[:, lv:lv + 1]).contiguous())
        hi = torch.searchsorted(tp, (tn - t_low[:, lv:lv + 1]).contiguous())
        pairs = torch.where(fin_n, (hi - lo).clamp(min=0), 0).sum()
        ops += int(2 * (fin_p + fin_n.sum()) + pairs)
    return ops


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(in_tensors, out_bytes: int, ops: int, peak=PEAK_F32_OPS_PER_S):
    """(bound_ms, bound_by, bytes): the least time for reading every input
    once, writing every output once and doing ``ops`` operations at
    ``peak`` per second (default: f32 outside the tensor cores), at the
    card's published peaks."""
    moved = sum(x.numel() * x.element_size() for x in in_tensors) + out_bytes
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", moved)


def device_profile(label: str, fn, card, warm_ms: float) -> None:
    """One call of ``fn`` under torch.profiler: device time per kernel name
    and the device's busy share (the union of device-side activity over the
    profiled wall time), logged beside ``warm_ms``, the same call's time on
    the host clock without the profiler. The profiler's own CUPTI buffer
    requests are not the program's work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not device:
        log(f"phase 5: {label} {warm_ms:.3f} ms wall; torch.profiler "
            "recorded no device activity, so the busy share is not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy_us += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy_ms = (busy_us + hi - lo) / 1e3
    by_name = {}
    for e in device:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    log(f"phase 5 ({card}): {label} {warm_ms:.3f} ms wall; under "
        f"torch.profiler {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"(share {busy_ms / wall_ms:.4f}), {len(device)} device activities")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:10.3f} ms  {count:4d}x  {name[:100]}")


def trace_mine(stream, cfg, card) -> None:
    """Phase 5: where a warm fused mine spends its time: one mine timed on
    the host clock, then one under torch.profiler."""
    t0 = time.perf_counter()
    mining.mine_arrays(stream, cfg)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    device_profile("warm fused mine", lambda: mining.mine_arrays(stream, cfg),
                   card, warm_ms)


def trace_decode(model, arch: str, card) -> None:
    """Phase 5 for a model: where its serve step (``Model.decode_step`` at
    the serve loop's batch, with sampling) spends its time. After two warm
    steps, TRACE_STEPS steps timed on the host clock, then as many under
    torch.profiler."""
    slots, cache_len = SERVE[arch][:2]
    cache = model.init_cache(slots, cache_len)
    tokens = torch.zeros(slots, dtype=torch.int32, device=DEVICE)
    sampler = torch.Generator(DEVICE).manual_seed(7)

    def steps(first: int, n: int):
        nonlocal cache, tokens
        for t in range(first, first + n):
            pos = torch.full((slots,), t, dtype=torch.int32, device=DEVICE)
            logits, cache = model.decode_step(cache, tokens, pos)
            probs = torch.softmax(logits.float(), dim=-1)
            tokens = torch.multinomial(probs, 1, generator=sampler)[:, 0].to(
                torch.int32)
            tokens.cpu()    # the serve loop reads every step's tokens

    steps(0, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(2, TRACE_STEPS)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    device_profile(f"{arch}: {TRACE_STEPS} warm serve steps at batch {slots}",
                   lambda: steps(2 + TRACE_STEPS, TRACE_STEPS), card, warm_ms)


# ---------------------------------------------------------------------------
# LM serving: the two kernels vs plain, the paths, the kernels' times
# ---------------------------------------------------------------------------


#: each LM kernel's wrapper as (module, attribute): the model layers look
#: the wrapper up there at every call
_WRAPPERS = {"flash_attention": (fa, "flash_attention"),
             "wkv_chunk": (wkv_chunk, "wkv_chunked")}


def lm_config(arch: str):
    cfg = get_config(arch)
    return cfg if LM_FULL_WIDTH else reduced(cfg)


def beyond(got, want, tol: float) -> str:
    """How many entries differ by more than ``tol + tol * |want|``."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > tol + tol * want.double().abs()).sum())
    return f"{bad} of {diff.numel()} entries beyond the plain {tol}"


def scale_of(want) -> float:
    """``max(1, max|want|)``: what a scaled tolerance's absolute part
    multiplies."""
    return max(1.0, float(want.float().abs().max()))


def close_err(name: str, got, want, tol: float, scale: float = 1.0) -> float:
    """The largest |got - want|; raises unless both are finite, of one
    shape, and every entry is within ``tol * scale + tol * |want|``."""
    got, want = got.double(), want.double()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: values that are not finite")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    bad = int((diff > tol * scale + tol * want.abs()).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {diff.numel()} entries beyond "
                             f"{tol} (scale {scale}); max_abs_err {err}")
    return err


def _randn(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def flash_inputs(seed, b, s, h, hk, hd, dtype):
    """Seeded q [b, s, h, hd], k and v [b, s, hk, hd]."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    return [_randn(gen, (b, s, n, hd), dtype) for n in (h, hk, hk)]


def wkv_inputs(seed, b, t, h, hd, dtype=torch.float32):
    """Seeded r, k, v [b, t, h, hd], log decays in the model's range
    [-1.5, -1e-4] and a bonus u [h, hd]."""
    gen = torch.Generator(DEVICE).manual_seed(seed)
    r, k, v = (_randn(gen, (b, t, h, hd), dtype) for _ in range(3))
    lw = -(torch.rand((b, t, h, hd), generator=gen, device=DEVICE)
           * (1.5 - 1e-4) + 1e-4)
    return r, k, v, lw, _randn(gen, (h, hd)) * 0.3


def lm_kernel_vs_plain(name, case, args, kwargs, tol, scaled) -> float:
    """One LM kernel against its plain version on the same inputs; raises
    unless within tolerance; returns the largest difference."""
    module, attr = _WRAPPERS[name]
    got = getattr(module, attr)(*args, **kwargs)
    torch.cuda.synchronize()
    want = plain_version(name)(*args, **kwargs)
    if got.dtype != want.dtype:
        raise AssertionError(f"{name} {case}: dtype {got.dtype} != {want.dtype}")
    scale = scale_of(want) if scaled else 1.0
    err = close_err(f"{name} kernel vs plain, {case}", got, want, tol, scale)
    log(f"  {name} {case}: shape {tuple(args[0].shape)}, within {tol}"
        f"{' x ' + format(scale, '.4f') if scaled else ''} of plain, "
        f"max_abs_err {err}")
    return err


def lm_kernels_vs_plain(errs: dict) -> None:
    """Phase 2 for the LM kernels, at the prefill shapes of phase 3 and
    beside them; tolerances of tests/test_kernels.py."""
    qcfg, rcfg = lm_config("qwen3-0.6b"), lm_config("rwkv6-3b")
    b, s = PREFILL_BATCH, PREFILL_SEQ
    heads = (qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim)
    f32, bf16 = torch.float32, torch.bfloat16
    for seed, (case, shape, dtype, causal, tol) in enumerate([
            ("bf16 causal (qwen3 prefill)", (b, s, *heads), bf16, True, 3e-2),
            ("bf16 causal, ragged s", (2, s // 4 - 24, *heads), bf16, True,
             3e-2),
            ("f32 causal", (2, 256, 4, 2, 64), f32, True, 2e-3),
            ("f32 non-causal", (1, 256, 2, 2, 64), f32, False, 2e-3),
            ("f32 non-causal, hd 32, ragged s", (1, 77, 4, 1, 32), f32, False,
             2e-3),
            # the hd 128 instantiation qwen3 runs at a bound a wrong tile
            # fails: bf16's 3e-2 is as large as a late row's entries
            ("f32 causal (qwen3 prefill shape)", (b, s, *heads), f32, True,
             2e-3)]):
        errs["flash_attention"].append(lm_kernel_vs_plain(
            "flash_attention", case, flash_inputs(seed, *shape, dtype),
            {"causal": causal}, tol, False))
    h, hd, chunk = rcfg.n_rwkv_heads, rcfg.rwkv_head_dim, rcfg.rwkv_chunk
    for seed, (case, shape, dtype, tol) in enumerate([
            (f"f32 (rwkv6 prefill), chunk {chunk}", (b, s, h, hd), f32, 2e-4),
            (f"f32, T {s - 1}: chunk {wkv_chunk.chunk_len(s - 1, chunk)}",
             (1, s - 1, h, hd), f32, 2e-4),
            ("f32, T 97: chunk 1", (1, 97, h, hd), f32, 2e-4),
            ("bf16", (2, 96, 3, 32), bf16, 4e-2)]):
        errs["wkv_chunk"].append(lm_kernel_vs_plain(
            "wkv_chunk", case, wkv_inputs(seed, *shape, dtype),
            {"chunk": chunk}, tol, True))


@contextlib.contextmanager
def replaced(owner, attr: str, value):
    """``owner.attr`` set to ``value`` for the duration of the block."""
    was = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, was)


def in_place_of(kernel: str, fn):
    """``fn`` in the kernel wrapper's module attribute, where the model
    layers look it up, for the duration of the block."""
    return replaced(*_WRAPPERS[kernel], fn)


def plain_version(kernel: str):
    module, attr = _WRAPPERS[kernel]
    return getattr(module, f"{attr}_ref")


def decode_positions(t: int):
    return torch.full((DECODE_BATCH,), t, dtype=torch.int32, device=DEVICE)


def layerwise_checks(model, tokens, dec, kernel: str) -> None:
    """Each layer of the full model, on the input the layers before it give
    it: its prefill output with the kernel against the same with the plain
    version, and its decode, token by token from an empty cache, against
    its full-sequence output. Within LAYER_TOL of ``max(1, max|want|)``:
    one layer's bf16 output rounds alike up to an ulp or two."""
    x, positions = model.embed_inputs(tokens)
    xd, pos_d = model.embed_inputs(dec)
    prefill_err = decode_err = 0.0
    for i, block in enumerate(model.layers):
        y = block(x, positions)
        with in_place_of(kernel, plain_version(kernel)):
            y_plain = block(x, positions)
        prefill_err = max(prefill_err, close_err(
            f"layer {i} prefill, kernel vs plain {kernel}", y, y_plain,
            LAYER_TOL, scale_of(y_plain)))
        yd = block(xd, pos_d)
        cache = block.init_cache(DECODE_BATCH, DECODE_LEN)
        steps = []
        for t in range(DECODE_LEN):
            out, cache = block.decode(cache, xd[:, t:t + 1], decode_positions(t))
            steps.append(out)
        decode_err = max(decode_err, close_err(
            f"layer {i} decode vs forward", torch.cat(steps, 1), yd, LAYER_TOL,
            scale_of(yd)))
        x, xd = y, yd
    log(f"  layer by layer, each on the same input: prefill with the kernel "
        f"within {LAYER_TOL} (scaled) of the plain {kernel} in all "
        f"{len(model.layers)} layers (max_abs_err {prefill_err}); "
        f"{DECODE_LEN} decode steps within {LAYER_TOL} (scaled) of the "
        f"layer's forward (max_abs_err {decode_err})")


def max_diff(got, want) -> float:
    return float((got.double() - want.double()).abs().max())


def perturb(out, gen):
    """``out`` (f32) scaled by 1 + CONTROL_REL x seeded normal noise."""
    noise = torch.randn(out.shape, generator=gen, device=out.device)
    return out * (1 + CONTROL_REL * noise)


def whole_model_checks(model, prefill, tokens, dec, logits, kernel) -> None:
    """The whole model: its last-position prefill logits with the kernel
    against those with the plain version, and its teacher-forced decode
    against ``Model.forward``. Over 28 or 32 layers of bf16 activations a
    random-weight model carries every flipped bf16 rounding on and
    amplifies it (rwkv6-3b far more than qwen3-0.6b), so no fixed bound
    both passes a right kernel and fails a wrong one. Each comparison is
    held against a control on the same logits instead: the largest
    difference, over CONTROL_DRAWS draws, that perturbations of rounding
    size make where the two compared runs round differently, times
    CONTROL_FACTOR. For the prefill that is the kernel's output (the plain
    version, perturbed); for decode it is every product (each dense
    product and the kernel's output, perturbed), since the decode step's
    products have other shapes than the forward's and round otherwise
    throughout. How many logits differ by more than tests/test_models.py's
    plain LM_TOL is printed beside; the layer-by-layer checks hold each
    layer far tighter."""
    plain = plain_version(kernel)
    gen = torch.Generator(DEVICE).manual_seed(3)

    def perturbed_kernel(*args, **kwargs):
        out = plain(*(a.float() for a in args), **kwargs)
        return perturb(out, gen).to(args[0].dtype)

    def perturbed_dense(self, x):
        y = x.to(torch.bfloat16).float() @ self.w.to(torch.bfloat16).float()
        y = perturb(y, gen).to(torch.bfloat16)
        return y if self.b is None else y + self.b.to(torch.bfloat16)

    with in_place_of(kernel, plain):
        plain_logits = prefill(tokens)
    full = model(dec)
    cache = model.init_cache(DECODE_BATCH, DECODE_LEN)
    steps = []
    for t in range(DECODE_LEN):
        lg, cache = model.decode_step(cache, dec[:, t], decode_positions(t))
        steps.append(lg)
    steps = torch.stack(steps, 1)
    prefill_control = decode_control = 0.0
    for _ in range(CONTROL_DRAWS):
        with in_place_of(kernel, perturbed_kernel):
            prefill_control = max(prefill_control,
                                  max_diff(prefill(tokens), plain_logits))
            with replaced(layers.Dense, "forward", perturbed_dense):
                decode_control = max(decode_control, max_diff(model(dec), full))
    for what, got, want, control, perturbed in (
            (f"prefill logits, kernel vs plain {kernel}", logits,
             plain_logits, prefill_control, f"the plain {kernel}'s output"),
            (f"{DECODE_LEN} decode steps vs Model.forward", steps, full,
             decode_control, f"every dense product and the {kernel} output")):
        name = f"whole model: {what}"
        close_err(name, got, want, float("inf"))    # shapes, finite values
        err = max_diff(got, want)
        limit = CONTROL_FACTOR * control
        log(f"  {name}: max_abs_err {err}, within {CONTROL_FACTOR} x the "
            f"control {control} (a {CONTROL_REL} relative perturbation of "
            f"{perturbed}, largest of {CONTROL_DRAWS} draws); "
            f"{beyond(got, want, LM_TOL)}")
        if err > limit:
            raise AssertionError(f"{name}: max_abs_err {err} beyond "
                                 f"{CONTROL_FACTOR} x the control {control}")


def drive_lm(arch: str, kernel: str, path_launches: dict, card) -> dict:
    """Phase 3 for one model: prefill (``kernel`` launched once a layer),
    the layer-by-layer and whole-model checks against the plain version
    and of decode against forward, the serve loop (twice). Returns its
    numbers."""
    cfg = lm_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device=DEVICE).init(
        torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} f32 parameters (seeded random), made in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ)), device=DEVICE)
    prefill = make_prefill_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = prefill(tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    path_launches[kernel] = read_launches()
    prefill_peak = torch.cuda.max_memory_allocated()
    expect_launches(f"{arch} prefill", path_launches[kernel],
                    {kernel: cfg.n_layers})
    if logits.shape != (PREFILL_BATCH, cfg.vocab) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{arch} prefill logits: shape "
                             f"{tuple(logits.shape)} or not finite")
    t0 = time.perf_counter()
    prefill(tokens)
    torch.cuda.synchronize()
    prefill_warm_s = time.perf_counter() - t0
    log(f"  prefill {tuple(tokens.shape)}: {prefill_s:.3f} s wall (first "
        f"call), {prefill_warm_s:.3f} s (second), peak "
        f"{prefill_peak / 2**30:.3f} GiB; last-position logits "
        f"{tuple(logits.shape)} finite")
    dec = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (DECODE_BATCH, DECODE_LEN)), device=DEVICE)
    layerwise_checks(model, tokens, dec, kernel)
    whole_model_checks(model, prefill, tokens, dec, logits, kernel)
    trace_decode(model, arch, card)
    del model, logits
    torch.cuda.empty_cache()

    slots, cache_len, requests, max_new = SERVE[arch]
    argv = ["--arch", arch, "--batch", str(slots), "--cache-len",
            str(cache_len), "--requests", str(requests), "--max-new",
            str(max_new), "--device", DEVICE]
    argv += [] if LM_FULL_WIDTH else ["--reduced"]
    # twice: the first call's window also holds its first steps' set-up
    # (a new model's cache, allocator growth); the second is the warm rate
    rates = [serve_loop(arch, argv, when)
             for when in ("first call", "second call")]
    return {"prefill_s": prefill_s, "prefill_warm_s": prefill_warm_s,
            "prefill_peak": prefill_peak, "serve_tokens_per_s": rates}


def serve_loop(arch: str, argv: list, when: str) -> float:
    """One ``serve.main`` call: every request answered in full, no kernel
    launched while decoding. Returns its tokens/s."""
    slots, _, requests, max_new = SERVE[arch]
    reset_launches()
    out = serve.main(argv)
    torch.cuda.synchronize()
    serve_launches = read_launches()
    if any(serve_launches.values()):
        raise AssertionError(f"{arch} serve: the decode path launched "
                             f"{serve_launches}")
    got = {len(toks) for toks in out["produced"].values()}
    if sorted(out["produced"]) != list(range(requests)) or got != {max_new}:
        raise AssertionError(f"{arch} serve: {len(out['produced'])} requests, "
                             f"token counts {got}, expected {requests} x "
                             f"{max_new}")
    log(f"  serve ({when}): {requests} requests x {max_new} tokens on "
        f"{slots} slots, every request answered in full; "
        f"{out['tokens_per_s']:.1f} tokens/s ({out['steps']} decode steps, "
        f"{out['seconds']:.3f} s); no kernel launched on the decode path")
    return out["tokens_per_s"]


def wkv_operations(b: int, t: int, h: int, hd: int, chunk: int) -> int:
    """f32 operations of the chunked WKV algebra: per (batch, head, chunk)
    the strictly causal score tile and its product with v, the carry-in
    and state-update products, and about twelve elementwise operations per
    chunk element (cumulative decays, exponentials, scalings, the bonus,
    the sums)."""
    pairs = chunk * (chunk - 1) // 2
    per_chunk = 4 * pairs * hd + 4 * chunk * hd * hd + 2 * hd * hd + \
        12 * chunk * hd
    return b * h * (t // chunk) * per_chunk


def lm_kernel_times(card, errs: dict, path_launches: dict) -> list:
    """Phase 4 for the LM kernels at the prefill shapes of phase 3."""
    qcfg, rcfg = lm_config("qwen3-0.6b"), lm_config("rwkv6-3b")
    b, s = PREFILL_BATCH, PREFILL_SEQ
    h, hk, hd = qcfg.n_heads, qcfg.n_kv_heads, qcfg.head_dim
    q, k, v = flash_inputs(11, b, s, h, hk, hd, torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    rw = wkv_inputs(12, b, s, rcfg.n_rwkv_heads, rcfg.rwkv_head_dim)
    chunk = rcfg.rwkv_chunk
    work = {
        # causal: half the s x s score and P V products, 2 FLOPs a MAC
        "flash_attention": ((q, k, v), {}, q.numel() * q.element_size(),
                            2 * 2 * b * h * s * s * hd // 2, PEAK_BF16_FLOPS,
                            sdpa, "bf16"),
        "wkv_chunk": (rw, {"chunk": chunk}, rw[0].numel() * 4,
                      wkv_operations(b, s, rcfg.n_rwkv_heads,
                                     rcfg.rwkv_head_dim, chunk),
                      PEAK_F32_OPS_PER_S, None, "f32"),
    }
    entries = []
    for name, (args, kwargs, out_bytes, n_ops, peak, library, dtype) in \
            work.items():
        wrapper, replaces = KERNELS[name]
        plain = plain_version(name)
        wrapper(*args, **kwargs)
        torch.cuda.synchronize()
        kernel_ms = time_cuda(lambda: wrapper(*args, **kwargs), 5)
        plain_ms = time_cuda(lambda: plain(*args, **kwargs), 1)
        library_ms = None
        if library is not None:
            close_err("sdpa vs the kernel", library().transpose(1, 2).float(),
                      wrapper(*args, **kwargs).float(), 3e-2)
            library_ms = time_cuda(library, 5)
        bound_ms, bound_by, moved = bound(args, out_bytes, n_ops, peak)
        launches = path_launches[name][name]
        log(f"phase 4 ({card}): {name} at {tuple(args[0].shape)} {dtype}: "
            f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, library "
            f"{library_ms if library_ms is None else format(library_ms, '.4f')}"
            f" ms, bound {bound_ms:.4f} ms by {bound_by} ({moved} bytes, "
            f"{n_ops} operations), share {bound_ms / kernel_ms:.4f}; "
            f"{launches} launches on its path")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs[name]), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
    return entries


def same_levels(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k].symbols, b[k].symbols)
        and np.array_equal(a[k].counts, b[k].counts)
        and a[k].n_candidates == b[k].n_candidates for k in a)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")

    # --- phase 1: the card, the kernels' build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t_build = time.perf_counter()
    _build.build_all()
    log(f"built {', '.join(_build.KERNELS)} in "
        f"{time.perf_counter() - t_build:.2f} s (one nvcc each, in parallel):")
    for name in _build.KERNELS:
        for line in ptxas_summary(_build.BUILD_LOG.get(name, "")):
            log(f"  nvcc {name}: {line}")
    # f32 products in full f32 (the plain versions' einsums): no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- data: paper Table II dataset 3
    net = spikes.NetworkConfig()
    duration = dict(spikes.PAPER_DATASETS)[DATASET] * SCALE
    t0 = time.perf_counter()
    stream = spikes.paper_dataset(DATASET, scale=SCALE, cfg=net)
    per_type = np.bincount(stream.types.numpy(), minlength=stream.n_types)
    cap = int(per_type.max())
    log(f"dataset {DATASET}: {stream.n_events} spikes over {duration} s, "
        f"{stream.n_types} neurons, busiest {cap} (cap class "
        f"{plan.capacity_class(cap)}); simulated in "
        f"{time.perf_counter() - t0:.2f} s")

    # --- phase 2: kernels vs plain on the card
    log("phase 2: kernels vs plain")
    errs = {name: [] for name in KERNELS}
    for case, batch in [
            ("seeded", seeded_batch(1, 64, 3, 1024)),
            ("0.25 tie grid", seeded_batch(2, 48, 4, 512, grid=True)),
            ("all-padding rows", seeded_batch(
                3, 8, 3, 256, empty={(i, s) for i in range(8)
                                     for s in range(3)})),
            ("cap 97", seeded_batch(4, 33, 2, 97, grid=True)),
            ("cap 130", seeded_batch(5, 17, 5, 130, empty={(3, 2)})),
            ("cap 257", seeded_batch(6, 9, 3, 257))]:
        for name, err in zip(KERNELS, all_kernels_vs_plain(case, batch)):
            errs[name].append(err)
    l2 = level2_batch(stream, cap)
    times, lo, hi, pe, pc = l2
    rows2 = level_rows(times, lo, hi)     # [4096, cap] rows of level 2
    for name, err in zip(KERNELS, all_kernels_vs_plain(
            "level-2 batch of phase 3", l2, chunk=PLAIN_CHUNK)):
        errs[name].append(err)
    lm_kernels_vs_plain(errs)

    # --- phase 3: the main path
    noise_est = spikes.noise_pair_estimate(net, duration)
    cfg = mining.MinerConfig(
        t_low=0.0, t_high=T_HIGH,
        threshold=max(5, int(0.35 * net.trigger_hz * duration)),
        level_thresholds={2: int(1.4 * noise_est)}, max_level=MAX_LEVEL,
        engine="dense_pallas_fused", max_candidates=net.n_neurons ** 2,
        cap=cap, device=DEVICE)
    log(f"phase 3: mine_arrays to level {MAX_LEVEL}, thresholds "
        f"{cfg.level_thresholds} / {cfg.threshold}, window (0, {T_HIGH}] s, "
        f"cap {cap}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fused = mining.mine_arrays(stream, cfg)
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    path_launches = {"count_batch": read_launches()}
    mine_peak = torch.cuda.max_memory_allocated()
    counted = [lv for lv in sorted(fused) if lv > 1 and fused[lv].n_candidates]
    for lv in sorted(fused):
        log(f"  level {lv}: {len(fused[lv].counts)} frequent of "
            f"{fused[lv].n_candidates} candidates")
    expect_launches("the fused mine", path_launches["count_batch"],
                    {"count_batch": len(counted)})
    if fused[2].n_candidates != net.n_neurons ** 2:
        raise AssertionError(f"level 2 held {fused[2].n_candidates} "
                             f"candidates, expected {net.n_neurons ** 2}")

    truth = spikes.embedded_episodes(net)
    prefixes = {ep.symbols[:lv] for ep in truth
                for lv in range(2, MAX_LEVEL + 1)}
    for lv in range(2, MAX_LEVEL + 1):
        rows = fused[lv].symbols.tolist() if lv in fused else []
        hits = [tuple(r) for r in rows if tuple(r) in prefixes]
        log(f"  level {lv}: {len(hits)} embedded-cascade prefixes, e.g. "
            f"{hits[:2]}")
        if not hits:
            raise AssertionError(f"no embedded cascade recovered at level {lv}")

    types_np, times_np = stream.types.numpy(), stream.times.numpy()
    for lv in counted:
        la = fused[lv]
        if not len(la.counts):
            continue
        for i in sorted({0, int(np.argmax(la.counts))}):
            ep = Episode(tuple(int(s) for s in la.symbols[i]),
                                (cfg.t_low,) * (lv - 1), (cfg.t_high,) * (lv - 1))
            # events of other types never move the FSM: feed it only these
            mask = np.isin(types_np, ep.symbols)
            want = statemachine.count_fsm_numpy(types_np[mask], times_np[mask], ep)
            log(f"  oracle: {ep} mined {int(la.counts[i])}, FSM {want}")
            if want != int(la.counts[i]):
                raise AssertionError(f"mined count of {ep} != FSM oracle")

    t0 = time.perf_counter()
    dense = mining.mine_arrays(stream, dataclasses.replace(cfg, engine="dense"))
    dense_s = time.perf_counter() - t0
    if not same_levels(fused, dense):
        raise AssertionError("dense_pallas_fused result != dense result")
    log(f"  engine='dense' on the card: same result, every level "
        f"({dense_s:.2f} s)")

    # the dense_pallas engine: one track_level launch per tracking level
    reset_launches()
    t0 = time.perf_counter()
    per_level = mining.mine_arrays(
        stream, dataclasses.replace(cfg, engine="dense_pallas"))
    torch.cuda.synchronize()
    per_level_s = time.perf_counter() - t0
    path_launches["track_level"] = read_launches()
    expect_launches("the dense_pallas mine", path_launches["track_level"],
                    {"track_level": sum(lv - 1 for lv in counted)})
    if not same_levels(fused, per_level):
        raise AssertionError("dense_pallas result != dense_pallas_fused result")
    log(f"  engine='dense_pallas': same result as the fused engine, every "
        f"level ({per_level_s:.2f} s)")

    # the tracking entry on the level-2 batch
    reset_launches()
    occ = tracking.track_batch_dispatch(
        "dense_pallas_fused", times, lo, hi, tracking.EngineConfig())
    torch.cuda.synchronize()
    path_launches["track_batch"] = read_launches()
    expect_launches("track_batch_dispatch('dense_pallas_fused')",
                    path_launches["track_batch"], {"track_batch": 1})
    want = [track_dense(times[i:i + PLAIN_CHUNK], lo[i:i + PLAIN_CHUNK],
                        hi[i:i + PLAIN_CHUNK])
            for i in range(0, times.shape[0], PLAIN_CHUNK)]
    for name in occ._fields:
        if not torch.equal(getattr(occ, name),
                           torch.cat([getattr(w, name) for w in want])):
            raise AssertionError(f"track_batch_dispatch {name} != track_dense")
    end_out, greedy = counting._greedy_batch_state(occ, pe, pc, False)
    k_counts, k_end, _ = episode_track.count_batch(*l2)
    if not (torch.equal(greedy, k_counts) and torch.equal(end_out, k_end)):
        raise AssertionError("greedy over track_batch_dispatch != count kernel")
    log(f"  track_batch_dispatch on {tuple(times.shape)}: starts, ends, "
        f"valid, n_superset, overflow == track_dense; greedy counts and "
        f"ends == the count kernel's ({int(occ.valid.sum())} valid "
        f"intervals)")

    # corpus mining: four recordings of Table II dataset 4
    c_duration = dict(spikes.PAPER_DATASETS)[CORPUS_DATASET] * SCALE
    t0 = time.perf_counter()
    recordings = [spikes.paper_dataset(
        CORPUS_DATASET, scale=SCALE, cfg=dataclasses.replace(net, seed=k))
        for k in CORPUS_SEEDS]
    c_cap = max(int(np.bincount(r.types.numpy()).max()) for r in recordings)
    c_cfg = dataclasses.replace(
        cfg, threshold=max(5, int(0.35 * net.trigger_hz * c_duration)),
        level_thresholds={2: int(
            1.4 * spikes.noise_pair_estimate(net, c_duration))},
        cap=c_cap)
    log(f"corpus: {len(recordings)} recordings of dataset {CORPUS_DATASET} "
        f"({c_duration} s, seeds {CORPUS_SEEDS}): "
        f"{[r.n_events for r in recordings]} spikes, busiest {c_cap} (cap "
        f"class {plan.capacity_class(c_cap)}), thresholds "
        f"{c_cfg.level_thresholds} / {c_cfg.threshold}; simulated in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    t0 = time.perf_counter()
    c_res = corpus.mine_corpus(recordings, c_cfg, min_streams=2)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    corpus_launches = read_launches()
    c_counted = sorted({lv for res in c_res.per_stream for lv in res
                        if lv > 1 and res[lv].n_candidates})
    expect_launches("mine_corpus (dense_pallas_fused)", corpus_launches,
                    {"count_batch": len(c_counted)})
    for k, rec in enumerate(recordings):
        if not same_levels(c_res.per_stream[k], mining.mine_arrays(rec, c_cfg)):
            raise AssertionError(f"mine_corpus stream {k} != its mine_arrays")
        log(f"  stream {k}: == mine_arrays; levels " + ", ".join(
            f"{lv}: {len(la.counts)}/{la.n_candidates}"
            for lv, la in sorted(c_res.per_stream[k].items())))
    log(f"  mine_corpus {corpus_s:.3f} s wall; every stream == its own "
        f"mine_arrays; >= 2 streams aggregate: " + ", ".join(
            f"level {lv}: {len(la.counts)} of {la.n_candidates}"
            for lv, la in sorted(c_res.corpus.items())))
    for lv, la in sorted(c_res.corpus.items()):
        if lv > 2 and len(la.counts):
            log(f"    level {lv}: e.g. {la.symbols[:2].tolist()} in "
                f"{la.counts[:2].tolist()} streams")
    reset_launches()
    t0 = time.perf_counter()
    c_per_level = corpus.mine_corpus(
        recordings, dataclasses.replace(c_cfg, engine="dense_pallas"),
        min_streams=2)
    torch.cuda.synchronize()
    expect_launches("mine_corpus (dense_pallas)", read_launches(),
                    {"track_level": sum(lv - 1 for lv in c_counted)})
    if not (all(same_levels(a, b) for a, b in zip(c_res.per_stream,
                                                  c_per_level.per_stream))
            and same_levels(c_res.corpus, c_per_level.corpus)):
        raise AssertionError("mine_corpus dense_pallas != dense_pallas_fused")
    log(f"  mine_corpus with engine='dense_pallas': same result "
        f"({time.perf_counter() - t0:.2f} s)")

    # LM serving at full width: one model at a time
    lm = {arch: drive_lm(arch, kernel, path_launches, card) for arch, kernel in
          (("qwen3-0.6b", "flash_attention"), ("rwkv6-3b", "wkv_chunk"))}

    # --- phase 4: times at the level-2 shape
    ops = needed_operations(times, lo, hi, 0)   # tracking of one level
    compacted = int(occ.valid.sum())            # intervals the fold visits
    b, n, c = times.shape
    work = {
        "count_batch": (l2, (l2, PLAIN_CHUNK), b * 12, ops + compacted),
        "track_batch": ((times, lo, hi), ((times, lo, hi), PLAIN_CHUNK),
                        b * c * 4 + b * 4, ops),
        "track_level": (rows2, (rows2, PLAIN_CHUNK), b * c * 4, ops),
    }
    entries = []
    for name, (args, (plain_args, chunk), out_bytes, n_ops) in work.items():
        wrapper, replaces = KERNELS[name]
        plain = getattr(episode_track, f"{name}_ref")
        wrapper(*args)
        torch.cuda.synchronize()
        kernel_ms = time_cuda(lambda: wrapper(*args), 10)
        plain_ms = time_cuda(lambda: plain(*plain_args, chunk=chunk), 1)
        bound_ms, bound_by, moved = bound(args, out_bytes, n_ops)
        launches = path_launches[name][name]
        log(f"phase 4 ({card}): {name} at {tuple(args[0].shape)}: kernel "
            f"{kernel_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({moved} bytes, {n_ops} "
            f"operations), share {bound_ms / kernel_ms:.4f}; {launches} "
            f"launches on its path")
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs[name]), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    entries += lm_kernel_times(card, errs, path_launches)
    for arch, nums in lm.items():
        cold, warm = nums["serve_tokens_per_s"]
        log(f"  {arch} ({card}): prefill of {PREFILL_BATCH} x {PREFILL_SEQ} "
            f"tokens {nums['prefill_s']:.3f} s wall (first call), "
            f"{nums['prefill_warm_s']:.3f} s (second), peak "
            f"{nums['prefill_peak'] / 2**30:.3f} GiB allocated; serve "
            f"{cold:.1f} tokens/s (first call), {warm:.1f} (second)")
    log(f"  mine (fused) {mine_s:.3f} s wall, peak "
        f"{mine_peak / 2**30:.3f} GiB allocated; whole run peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    trace_mine(stream, cfg, card)

    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the card's name and power limit, as ``nvidia-smi`` reports them; the
   three CUDA kernels built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and ``nvcc``'s register report;
2. kernel vs plain: each kernel (``count_batch``, ``track_batch``,
   ``track_level``) against its plain PyTorch version on the card, bit for
   bit, on seeded batches, a 0.25 tie grid, all-padding rows, odd
   capacities and the real level-2 batch of phase 3;
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
4. times: each kernel at its level-2 shape (CUDA events) beside its bound
   and its plain version's time, the wall time of the mine, peak memory;
5. one more (warm) fused mine on the host clock, and one under
   torch.profiler: device time by kernel and the device's busy share.

Prints one JSON line of kernel measurements and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a card or without the repository's ``src/`` beside it.
"""
import dataclasses
import json
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
from repro_torch.kernels import _build, episode_track  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 ops/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
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
#: the kernels, their wrappers and the TPU kernels they replace
KERNELS = {
    "count_batch": (episode_track.count_batch,
                    "src/repro/kernels/episode_track.py:382"),
    "track_batch": (episode_track.track_batch,
                    "src/repro/kernels/episode_track.py:213"),
    "track_level": (episode_track.track_level,
                    "src/repro/kernels/episode_track.py:89"),
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


def bound(in_tensors, out_bytes: int, ops: int):
    """(bound_ms, bound_by, bytes): the least time for reading every input
    once, writing every output once and doing ``ops`` f32 operations, at
    the card's published peaks."""
    moved = sum(x.numel() * x.element_size() for x in in_tensors) + out_bytes
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", moved)


def trace_mine(stream, cfg, card) -> None:
    """Phase 5: where a warm fused mine spends its time. One mine timed on
    the host clock, then one under torch.profiler: device time per kernel
    name and the device's busy share (the union of device-side activity
    over the profiled wall time). The profiler's own CUPTI buffer requests
    are not the program's work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    mining.mine_arrays(stream, cfg)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mining.mine_arrays(stream, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not device:
        log(f"phase 5: warm fused mine {warm_ms:.3f} ms wall; torch.profiler "
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
    log(f"phase 5 ({card}): warm fused mine {warm_ms:.3f} ms wall; under "
        f"torch.profiler {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
        f"(share {busy_ms / wall_ms:.4f})")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:10.3f} ms  {count:4d}x  {name[:100]}")


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
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            log(f"  nvcc {name}: {line}")

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

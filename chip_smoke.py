#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trivy_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card (name, power limit) and build the CUDA kernels from
     the sources in this checkout;
  2. hold the match kernel against its plain PyTorch version on the
     card, bit for bit, over ragged DB sizes, windows and batch sizes;
  3. drive the match engine's main path at trivy-db scale: a synthetic
     2,000,000-advisory DB resident on the card answering a 240,000-query
     registry-crawl stream through MatchEngine.detect_many, checked
     against the host oracle and MatchEngine.detect / submit on a sample
     that includes hot- and tall-tier names, with the kernel's launches
     counted per tier; then time the kernel and its plain version at the
     main path's shapes and compute the kernel's memory bound.
Prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import math
import random
import subprocess
import sys
import time

import numpy as np

N_ADVISORIES = 2_000_000  # synth_trivy_db default; trivy-db scale
N_QUERIES = 240_000
BATCH = 131_072
SAMPLE = 4_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
TIMED_ITERS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, reps: int = 7) -> float:
    """Device time of one call: the median over `reps` runs of CUDA
    events around `iters` back-to-back calls, over the count, after
    three warm-up calls. Where a call's host side (argument checks,
    allocation, launch) takes longer than its kernel, this is the host's
    rate of launching."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return float(np.median(runs))


def device_busy_ms(prof, key: str | None = None) -> tuple[float, int]:
    """Summed device time (ms) and count of the profiled device events
    whose name contains `key` (all of them when None)."""
    total_us = 0.0
    count = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and (key is None or key in e.key):
            total_us += us
            count += e.count
    return total_us / 1e3, count


def kernel_ms(fn, iters: int, key: str) -> float | None:
    """The kernel's own device time per launch, from torch.profiler's
    CUDA activity (None when the profiler reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiling run now and then reports no device events for
    # kernels this short; a fresh run usually does
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms, count = device_busy_ms(prof, key)
        if count:
            return ms / count
    return None


def words_err(a, b) -> int:
    """Max |a - b| over two int32 word tensors read as uint32."""
    ua = a.cpu().numpy().view(np.uint32).astype(np.int64)
    ub = b.cpu().numpy().view(np.uint32).astype(np.int64)
    return int(np.abs(ua - ub).max()) if ua.size else 0


# --------------------------------------------------------------- phase 2


def make_case(rng: np.random.Generator, n: int, window: int, b: int):
    """A random sorted row table of `n` rows and `b` queries against it.

    Name groups of 1..window rows (some wider than 32 so hits land on
    bit 31), h1 values across the whole uint32 range (top bit set on
    about half), h1 collisions with distinct h2, every flag mix, and a
    tail of shard pad rows (h1 = h2 = 0xFFFFFFFF, hi = -1). Queries hit
    group starts, mismatch h2, miss, or query the last group."""
    n_pad = min(n // 10, 16)
    n_real = n - n_pad
    sizes = []
    while sum(sizes) < n_real:
        big = rng.random() < 0.2
        sizes.append(int(rng.integers(1, window + 1)) if big
                     else int(rng.integers(1, 6)))
    sizes[-1] -= sum(sizes) - n_real
    sizes = [s for s in sizes if s > 0]
    g = len(sizes)
    g_h1 = np.sort(rng.integers(0, 2**32 - 1, size=g, dtype=np.uint64)
                   ).astype(np.uint32)
    # about one group in eight shares its h1 with the previous group
    share = rng.random(g) < 0.125
    share[0] = False
    g_h1 = np.where(share, np.roll(g_h1, 1), g_h1).astype(np.uint32)
    g_h2 = rng.integers(0, 2**32 - 1, size=g, dtype=np.uint64).astype(
        np.uint32)
    h1 = np.repeat(g_h1, sizes)
    h2 = np.repeat(g_h2, sizes)
    order = np.lexsort((h2, h1))
    h1, h2 = h1[order], h2[order]
    lo = rng.integers(-4, 40, size=n_real).astype(np.int32)
    hi = (lo + rng.integers(-2, 40, size=n_real)).astype(np.int32)
    flags = rng.choice(np.array([0, 0, 0, 1, 4, 5], dtype=np.int32),
                       size=n_real)
    pad = np.full(n_pad, 0xFFFFFFFF, dtype=np.uint32)
    h1 = np.concatenate([h1, pad])
    h2 = np.concatenate([h2, pad])
    lo = np.concatenate([lo, np.zeros(n_pad, np.int32)])
    hi = np.concatenate([hi, np.full(n_pad, -1, np.int32)])
    flags = np.concatenate([flags, np.zeros(n_pad, np.int32)])

    pick = rng.integers(0, n_real, size=b)
    kind = rng.random(b)
    q_h1 = h1[pick].copy()
    q_h2 = h2[pick].copy()
    q_h2[(kind > 0.8) & (kind <= 0.9)] ^= np.uint32(1)  # h2 mismatch
    miss = kind > 0.9
    q_h1[miss] = rng.integers(0, 2**32 - 1, size=int(miss.sum()),
                              dtype=np.uint64).astype(np.uint32)
    q_h1[-1], q_h2[-1] = h1[n_real - 1], h2[n_real - 1]  # the last row
    q_rank = rng.integers(-4, 80, size=b).astype(np.int32)
    q_rank[-1] = 0
    q_flags = rng.choice(np.array([0, 1, 2, 3], dtype=np.int32), size=b)
    q_flags[-1] = 1  # NEEDS_HOST: the last row hits whatever its interval
    return (h1, h2, lo, hi, flags), (q_h1, q_h2, q_rank, q_flags)


def check_kernel_cases(dev) -> dict:
    """Kernel == plain version, bit for bit, over N x W x B."""
    import torch

    from trivy_tpu_torch.ops import match as m

    rng = np.random.default_rng(20261016)
    err = 0
    cases = 0
    bit31 = last_row = 0
    for n in (1, 1000, 200_000):
        for window in (8, 40, 512, 4000):
            for b in (1, 127, 129, 4501):
                rows, q = make_case(rng, n, window, b)
                ddb = m.DeviceDB.from_arrays(*rows, window=window,
                                             device=dev)
                qt = [torch.from_numpy(a.view(np.int32)).to(dev) for a in q]
                got = m.match_words(ddb, *qt)
                ref = m.match_words_ref(ddb, *qt)
                torch.cuda.synchronize()
                e = words_err(got, ref)
                if e:
                    raise AssertionError(
                        f"match kernel differs from its plain version: "
                        f"N={n} W={window} B={b} max_abs_err={e}")
                err = max(err, e)
                cases += 1
                words = ref.cpu().numpy().view(np.uint32)
                bit31 += int(((words >> 31) & 1).sum())
                # the last query asks for the last real row's name
                # (NEEDS_HOST): its bit must be set when in the window
                h1 = rows[0]
                last = n - min(n // 10, 16) - 1
                off = last - int(np.searchsorted(h1, q[0][-1]))
                if off < words.shape[1] * 32:
                    last_row += int((words[-1, off // 32] >> (off % 32)) & 1)
    if not bit31 or not last_row:
        raise AssertionError(
            f"case set lacks coverage: bit31 hits={bit31}, "
            f"last-row hits={last_row}")
    print(f"phase2 kernel_vs_plain cases={cases} max_abs_err={err} "
          f"bit31_hits={bit31} last_row_queries_hit={last_row}")
    return {"max_abs_err": err}


# --------------------------------------------------------------- phase 3


def build_queries(db, n_queries: int, hot_frac: float = 0.15,
                  miss_frac: float = 0.1, seed: int = 13):
    """Registry-crawl shape: many images with heavily overlapping
    package sets (popular base packages recur across nearly all)."""
    from trivy_tpu_torch.tensorize.synth import synth_queries

    rng = random.Random(11)
    uniq = synth_queries(db, max(n_queries // 8, 1), seed=seed,
                         hot_frac=hot_frac, miss_frac=miss_frac)
    # a base-image core repeated in every "image" + per-image tail
    base = uniq[:100]
    out = []
    while len(out) < n_queries:
        out.extend(base)
        for _ in range(20):
            out.append(uniq[rng.randrange(len(uniq))])
    return out[:n_queries]


def pick_sample(engine, queries, size: int) -> list[int]:
    """Stream positions of a deterministic sample of unique queries:
    every hot- and tall-tier name first (up to a quarter each), then
    main-tier names."""
    cdb = engine.cdb
    seen = set()
    hot, tall, rest = [], [], []
    for i, q in enumerate(queries):
        if q.key in seen:
            continue
        seen.add(q.key)
        key = (q.space, q.name)
        if key in cdb.tall_names:
            tall.append(i)
        elif key in cdb.host_fallback:
            hot.append(i)
        else:
            rest.append(i)
    out = hot[: size // 4] + tall[: size // 4]
    return out + rest[: size - len(out)]


def row_bytes_needed(key_h1: np.ndarray, q_h1: np.ndarray,
                     n_words: int) -> tuple[int, int]:
    """Bytes the match must read for these queries, each input byte
    once: the distinct 32-byte rows up to the word where a query's name
    group ends (no later row can hit), and one 4-byte key per distinct
    search result. -> (row bytes, search bytes)."""
    n = len(key_h1)
    start = np.searchsorted(key_h1, q_h1, side="left").astype(np.int64)
    run = np.searchsorted(key_h1, q_h1, side="right").astype(np.int64) - start
    words = np.minimum(n_words, run // 32 + 1)
    end = np.minimum(start + 32 * words, n)
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    prev_end = np.concatenate([[0], np.maximum.accumulate(e)[:-1]])
    rows = int(np.maximum(0, e - np.maximum(s, prev_end)).sum())
    return rows * 32, len(np.unique(start)) * 4


def time_tier(name: str, ddb, key_h1: np.ndarray, sub, dev) -> dict:
    """Time the kernel and its plain version on one tier's inputs of one
    pipeline chunk; check they agree; compute the bound."""
    import torch

    from trivy_tpu_torch.ops import match as m

    order, q = m.query_tensors(sub, dev)
    b = len(order)
    nw = m._words(ddb.window)
    got = m.match_words(ddb, *q)
    ref = m.match_words_ref(ddb, *q)
    torch.cuda.synchronize()
    err = words_err(got, ref)
    if err:
        raise AssertionError(f"{name}: kernel differs from plain version")
    ms = time_ms(lambda: m.match_words(ddb, *q), TIMED_ITERS)
    dev_ms = kernel_ms(lambda: m.match_words(ddb, *q), TIMED_ITERS,
                       "match_kernel")
    plain_ms = time_ms(lambda: m.match_words_ref(ddb, *q), 5, reps=3)
    row_b, search_b = row_bytes_needed(key_h1, np.sort(sub.h1), nw)
    io_b = b * 16 + b * nw * 4  # query columns in, words out
    need_b = row_b + search_b + io_b
    full_b = (b * nw * 32 * 32 + b * math.ceil(math.log2(ddb.n_rows + 1)) * 4
              + io_b)
    bound_ms = need_b / HBM_BYTES_PER_S * 1e3
    out = {"B": b, "W": ddb.window, "N": ddb.n_rows, "ms": ms,
           "kernel_device_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bytes_needed": need_b, "bytes_full_window": full_b,
           "full_window_bound_ms": full_b / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err}
    print(f"phase3 kernel tier={name} " + json.dumps(out))
    return out


def main_path(dev) -> dict:
    from trivy_tpu_torch.detector.engine import MatchEngine
    from trivy_tpu_torch.ops import match as m
    from trivy_tpu_torch.tensorize.compile import PackageBatch
    from trivy_tpu_torch.tensorize.synth import synth_trivy_db

    t0 = time.perf_counter()
    db = synth_trivy_db(n_advisories=N_ADVISORIES)
    queries = build_queries(db, N_QUERIES)
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = MatchEngine(db, device=dev)
    t_engine = time.perf_counter() - t0
    cdb = engine.cdb
    tiers = {"main": engine._ddb, "hot": engine._ddb_hot,
             "tall": engine._ddb_tall}
    if any(t is None for t in tiers.values()):
        raise AssertionError(f"a tier is empty: {cdb.stats}")
    print(f"phase3 db advisories={N_ADVISORIES} synth_s={t_synth:.3f} "
          f"engine_build_s={t_engine:.3f} stats={json.dumps(cdb.stats)}")

    # the main path, with every launch count at 0 just before it
    m.match_words.launches = 0
    for t in tiers.values():
        t.launches = 0
    t0 = time.perf_counter()
    res = engine.detect_many(queries, BATCH)
    wall = time.perf_counter() - t0
    launches = m.match_words.launches
    per_tier = {k: t.launches for k, t in tiers.items()}
    print(f"phase3 detect_many queries={len(queries)} wall_s={wall:.3f} "
          f"pkg_per_s={len(queries) / wall:.1f} "
          f"matches={sum(len(r.adv_indices) for r in res)} "
          f"launches={launches} per_tier={json.dumps(per_tier)} "
          f"pipeline={json.dumps(engine.last_pipeline_stats)}")
    if not all(per_tier.values()):
        raise AssertionError(f"a tier was never launched: {per_tier}")

    # right answers: the oracle, detect and submit on a sample
    idx = pick_sample(engine, queries, SAMPLE)
    sample = [queries[i] for i in idx]
    t0 = time.perf_counter()
    oracle = [r.adv_indices for r in engine.oracle_detect(sample)]
    t_oracle = time.perf_counter() - t0
    crawl = [res[i].adv_indices for i in idx]
    det = [r.adv_indices for r in engine.detect(sample)]
    half = len(sample) // 2
    sub = engine.submit([sample[:half], sample[half:]])
    subm = [r.adv_indices for rl in sub for r in rl]
    n_hot = sum((q.space, q.name) in cdb.host_fallback for q in sample)
    n_tall = sum((q.space, q.name) in cdb.tall_names for q in sample)
    diff = sum(a != b for a, b in zip(oracle, crawl))
    diff += sum(a != b for a, b in zip(oracle, det))
    diff += sum(a != b for a, b in zip(oracle, subm))
    print(f"phase3 check sample={len(sample)} hot_or_tall={n_hot} "
          f"tall={n_tall} oracle_s={t_oracle:.3f} "
          f"oracle_matches={sum(map(len, oracle))} diff_vs_oracle={diff}")
    if diff or not n_tall or n_hot <= n_tall:
        raise AssertionError("main path disagrees with the oracle, or the "
                             "sample lacks hot/tall names")

    # where the time goes: the same crawl again with a cold crawl cache
    # (the rescreen memo stays warm), under torch.profiler's CUDA
    # activity, for the device's busy and idle share of the wall time
    from torch.profiler import ProfilerActivity, profile

    engine._crawl_cache.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = engine.detect_many(queries, BATCH)
        wall2 = time.perf_counter() - t0
    busy_ms, _ = device_busy_ms(prof)
    kern_ms, kern_n = device_busy_ms(prof, "match_kernel")
    if [r.adv_indices for r in again] != [r.adv_indices for r in res]:
        raise AssertionError("profiled rerun disagrees with the main path")
    print(f"phase3 profiled_rerun wall_s={wall2:.3f} "
          f"device_busy_ms={busy_ms:.3f} match_kernel_ms={kern_ms:.3f} "
          f"match_kernel_launches={kern_n} "
          f"device_idle_share={1 - busy_ms / 1e3 / wall2:.6f} "
          f"pipeline={json.dumps(engine.last_pipeline_stats)}")

    # kernel time at the main path's shapes: one pipeline chunk of the
    # crawl's unique queries, routed to the three tiers as the engine does
    stats = engine.last_pipeline_stats or {}
    chunk = stats.get("chunk") or BATCH
    uniq = list(dict.fromkeys(q.key for q in queries))[:chunk]
    batch = cdb.encode_packages(uniq)
    timings = {}
    for name, route, key_h1 in (("main", None, cdb.row_h1),
                                ("hot", 1, cdb.hot_h1),
                                ("tall", 2, cdb.tall_h1)):
        sel = (np.arange(len(uniq)) if route is None
               else np.nonzero(batch.route == route)[0])
        part = PackageBatch(h1=batch.h1[sel], h2=batch.h2[sel],
                            rank=batch.rank[sel], flags=batch.flags[sel],
                            queries=[uniq[j] for j in sel])
        timings[name] = time_tier(name, tiers[name], key_h1, part, dev)
        if name == "main":
            # the main tier's rows under the 512-row window the main
            # tier had before tall names split off (W the kernel was
            # sized for); an extra shape, not a main-path launch
            wide = m.DeviceDB.from_arrays(
                cdb.row_h1, cdb.row_h2, cdb.row_lo, cdb.row_hi,
                cdb.row_flags, window=512, device=dev)
            timings["main_w512"] = time_tier("main_w512", wide, key_h1,
                                             part, dev)
            del wide
    return {"launches": launches, "per_tier": per_tier, "timings": timings,
            "pkg_per_s": len(queries) / wall}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # imported first so that a missing install shows at once
    import packaging.version  # noqa: F401

    from trivy_tpu_torch.device import resolve_device
    from trivy_tpu_torch.ops import kernels

    t_all = time.perf_counter()
    dev = resolve_device()
    card = card_line()
    print(f"phase1 card {card}")
    t0 = time.perf_counter()
    kernels.load("match")
    print(f"phase1 build match.cu seconds={time.perf_counter() - t0:.3f}")

    t0 = time.perf_counter()
    p2 = check_kernel_cases(dev)
    print(f"phase2 seconds={time.perf_counter() - t0:.3f}")

    t0 = time.perf_counter()
    p3 = main_path(dev)
    print(f"phase3 seconds={time.perf_counter() - t0:.3f}")

    main_t = p3["timings"]["main"]
    entry = {
        "name": "match", "route": "cuda",
        "source": "trivy_tpu_torch/ops/csrc/match.cu",
        "replaces": "trivy_tpu/ops/match.py:169",
        "launches": p3["launches"],
        "max_abs_err": max(p2["max_abs_err"],
                           *(t["max_abs_err"]
                             for t in p3["timings"].values())),
        "ms": main_t["ms"], "kernel_device_ms": main_t["kernel_device_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_per_tier": p3["per_tier"],
        "tiers": p3["timings"],
    }
    print(f"total seconds={time.perf_counter() - t_all:.3f}")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The secret system: a CI secret scan on `SecretScanner.scan_files`.

Set-up: the scanner is built with trivy's built-in rules on the device
(its compiled-NFA cache lives under the benchmark's cache directory),
the pool of files is generated from the seed, and warm-up scans files
of the pool's sizes that the window never uses.

Window: calls of `files_per_call` files go through
`scan_files(..., use_device=True)` one after another until the calls'
own seconds reach `--seconds`; the window is the sum of the calls'
spans. The calls cycle through the pool in an order drawn from the
seed, each file under a path no earlier call used.

Correctness: after the window, every appearance in the window of a
sample of the pool's files (every file with a plant, the largest, and a
share of the rest, drawn from the seed) is compared finding for finding
with the plain reference.
"""

from __future__ import annotations

import gc
import random
import sys
import time

from portbench.gen.corpus import make_pool
from portbench.lib.record import Check, Run
from portbench.lib.trace import DeviceTrace

STAT_KEYS = ("files", "chunks", "chunk_s", "dispatch_s", "wait_s",
             "verify_s")


def path_of(call: int, slot: int, ext: str) -> str:
    return f"ci/{call:06d}/src/{slot // 100:03d}/m{slot}.{ext}"


def finding_rows(secret) -> list[tuple]:
    """A program `Secret` as the reference's rows: (start line, rule ID,
    end line, censored line, offset), sorted."""
    return sorted((f.start_line, f.rule_id, f.end_line, f.match, f.offset)
                  for f in secret.findings)


def sample_files(pool: list, traffic: dict, seed: int) -> set[int]:
    """Pool files whose appearances are checked: every planted file, the
    `check_largest` largest, and a `check_share` of the rest."""
    rng = random.Random(seed * 104729 + 3)
    planted = {i for i, f in enumerate(pool) if f.kinds}
    largest = sorted(range(len(pool)), key=lambda i: -len(pool[i].body))
    out = planted | set(largest[: traffic["check_largest"]])
    rest = [i for i in range(len(pool)) if i not in out]
    n = int(round(len(rest) * traffic["check_share"]))
    return out | set(rng.sample(rest, n))


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, cache: str, t_start: float, fault=None) -> Run:
    """One run of a secret cell. `fault`, for the harness's own tests,
    rewrites each call's answers before they are kept."""
    from trivy_tpu_torch.secret.scanner import SecretScanner

    import torch

    on_card = device.startswith("cuda")
    t = time.perf_counter()
    scanner = SecretScanner(device=device)
    pool = make_pool(traffic, cfg["shape_seed"], seed)
    pool_s, t = time.perf_counter() - t, time.perf_counter()
    warm_traffic = dict(traffic, pool_files=traffic["warmup_files"])
    warm = make_pool(warm_traffic, cfg["shape_seed"], seed ^ 0x3A3A3A)
    per = traffic["files_per_call"]
    for i in range(0, len(warm), per):
        scanner.scan_files([(f"warm/{i + j}/w.{f.ext}", f.body)
                            for j, f in enumerate(warm[i: i + per])],
                           use_device=True)
    del warm
    order = list(range(len(pool)))
    random.Random(seed * 31 + 7).shuffle(order)
    check = sample_files(pool, traffic, seed)
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    run = Run(system="secret", setup_s=time.perf_counter() - t_start)
    run.notes.update(inputs_s=pool_s, warmup_s=time.perf_counter() - t,
                     program_source=scanner.program_source)
    stats0 = {k: scanner.device_stats[k] for k in STAT_KEYS}
    from trivy_tpu_torch.ops import secret_nfa as nfa

    launches0 = nfa.anchor_words.launches
    kept = []  # (pool index, path, program's rows)
    done_bytes = 0
    n_calls = 0
    prog_s = 0.0
    w0 = time.perf_counter()
    with DeviceTrace(trace) as tr:
        while prog_s < seconds:
            idx = [order[(n_calls * per + j) % len(pool)] for j in range(per)]
            batch = [(path_of(n_calls, j, pool[i].ext), pool[i].body)
                     for j, i in enumerate(idx)]
            c0 = time.perf_counter()
            try:
                with tr.call():
                    res = scanner.scan_files(batch, use_device=True)
                if fault is not None:
                    res = fault(res)
            except Exception as exc:  # a failed call fails its files
                print(f"call {n_calls} failed: {exc!r}", file=sys.stderr)
                run.failed += len(batch)
                res = None
            c1 = time.perf_counter()
            prog_s += c1 - c0
            run.call_s.append(c1 - c0)
            run.attempted += len(batch)
            if res is not None:
                done_bytes += sum(len(c) for _p, c in batch)
            # a file of a failed call is kept as None, and is wrong
            by_path = {} if res is None else {s.file_path: s for s in res}
            for (path, _c), i in zip(batch, idx):
                if i in check:
                    s = by_path.get(path, [])
                    kept.append((i, path, None if res is None else s))
            n_calls += 1
    run.window_s = prog_s
    run.notes["wall_window_s"] = time.perf_counter() - w0
    run.trace = tr.reduce()
    run.done["file_bytes"] = done_bytes
    run.counters = {k: scanner.device_stats[k] - stats0[k]
                    for k in STAT_KEYS}
    run.counters["calls"] = n_calls
    run.counters["anchor_launches"] = nfa.anchor_words.launches - launches0
    run.inputs = {"file_bytes": done_bytes}
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.device_kind = torch.cuda.get_device_name(0)
    got = [(i, path, s if s is None or isinstance(s, list)
            else finding_rows(s)) for i, path, s in kept]
    scanner.close()
    del scanner, kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    judge(run, pool, got)
    return run


def judge(run: Run, pool: list, got: list) -> None:
    """Hold the kept findings `got` [(pool index, path, rows, or None
    where the call failed)] to the plain reference: the run's one check
    counts the file appearances whose findings differ or never came."""
    from portbench.reference.secret import SecretReference

    ref = SecretReference()
    want: dict[int, list] = {}
    wrong = 0
    for i, path, rows in got:
        if i not in want:
            want[i] = sorted(ref.scan(path, pool[i].body))
        wrong += want[i] != rows
    run.checks = [Check("files_wrong", wrong, 0)]
    run.notes["files_checked"] = len(got)
    run.notes["pool_files_checked"] = len(want)


def control(cfg: dict, traffic: dict, seed: int, seconds: float,
            n_calls: int, cache: str) -> Run:
    """The control at the cell's size: the lossy reference scans the
    files a run of `n_calls` calls would check, and is judged as the
    program is."""
    from portbench.reference.secret import SecretReference

    pool = make_pool(traffic, cfg["shape_seed"], seed)
    order = list(range(len(pool)))
    random.Random(seed * 31 + 7).shuffle(order)
    check = sample_files(pool, traffic, seed)
    per = traffic["files_per_call"]
    lossy = SecretReference(lossy=True)
    seen: dict[int, list] = {}
    got = []
    for k in range(n_calls):
        for j in range(per):
            i = order[(k * per + j) % len(pool)]
            if i in check:
                path = path_of(k, j, pool[i].ext)
                if i not in seen:
                    seen[i] = sorted(lossy.scan(path, pool[i].body))
                got.append((i, path, seen[i]))
    run = Run(system="secret")
    judge(run, pool, got)
    return run

"""The crawl system: a registry crawl's detect phase on `MatchEngine`.

Set-up: the configuration's DB is generated and written under the
benchmark's DB root on the first run in a checkout (the DB is the
deployment's, one snapshot for every seed, as one trivy-db serves every
scan), the program loads it (`AdvisoryDB.load`) and builds its engine
on the device (`MatchEngine(db_path=...)`, whose compiled-DB cache
under that root serves every later run), and the registry, where the
traffic has one, is drawn. Warm-up runs calls whose keys the window
never uses.

Window: calls of `images_per_call` images' package lists go through
`MatchEngine.detect_many` one after another until the calls' own
seconds reach `--seconds`. Each call is drawn from the seed just before
it is sent, outside the timed span, so a faster program gets more calls
and never runs out; the window is the sum of the calls' spans.

Correctness: after the window, for a sample of the window's queries
drawn from the seed (a share of them at hot names, whose answers are
long), the advisory identities the program answered are compared with
the plain reference's. A sample finds a fault of a class (a tier, a
name's advisories, a version edge), not one stray answer among millions.
"""

from __future__ import annotations

import gc
import itertools
import os
import random
import shutil
import sys
import time

from portbench.gen import advisories, images
from portbench.lib.record import Check, Run
from portbench.lib.trace import DeviceTrace

SAMPLE_RANDOM = 512  # queries of a call kept for the check, anywhere
SAMPLE_HOT = 32  # and among its hot-name queries
CHECK_RANDOM = 16384  # of those kept, checked a run, anywhere
CHECK_HOT = 512  # and at hot names


def load_inputs(cfg: dict, cache: str) -> tuple[str, dict]:
    """-> (DB root, buckets) of the configuration, generated from its
    `db_seed` and written on a miss."""
    root = os.path.join(cache, "db", cfg["name"])
    if os.path.exists(os.path.join(root, "metadata.json")):
        return root, advisories.read_db(root)
    shutil.rmtree(root, ignore_errors=True)
    buckets = advisories.make_db(cfg, cfg["db_seed"])
    advisories.write_db(buckets, root)
    return root, buckets


class Calls:
    """The traffic of one run, drawn from the seed one call at a time: the
    warm-up calls first, then the window's. A call is a list of key lists,
    one an image; a registry's calls share the lists of the images they
    draw, by index."""

    def __init__(self, cfg: dict, traffic: dict, buckets: dict, seed: int):
        self.gen = images.ImageGen(cfg, traffic, buckets, seed)
        self.hot = hot_names(self.gen)
        self.seed = seed
        self.per = traffic["images_per_call"]
        self.warm = list(itertools.islice(images.fresh_calls(
            self.gen, traffic, cfg["shape_seed"] + 1, self.per,
            traffic["warmup_calls"]), traffic["warmup_calls"]))
        reg = traffic.get("registry")
        self.registry = None
        if reg is None:
            self._fresh = images.fresh_calls(self.gen, traffic,
                                             cfg["shape_seed"], self.per)
        else:
            sizes = images.image_sizes(traffic, reg["images"],
                                       cfg["shape_seed"])
            self.registry = images.Registry(self.gen, reg, sizes)
        self._hot_at: dict[int, list[int]] = {}
        self.k = 0

    def _hot_positions(self, image: list, index) -> list[int]:
        pos = None if index is None else self._hot_at.get(index)
        if pos is None:
            pos = [j for j, key in enumerate(image)
                   if (key[0], key[1]) in self.hot]
            if index is not None:
                self._hot_at[index] = pos
        return pos

    def next_call(self) -> tuple[list, list | None, list[int]]:
        """-> (the call's images, their registry indices or None, the
        positions of the call kept for the check)."""
        if self.registry is None:
            call, idx = next(self._fresh), None
        else:
            idx = self.registry.draw_call(self.per)
            call = [self.registry.images[i] for i in idx]
        hot_pos = []
        n = 0
        for j, image in enumerate(call):
            hot_pos.extend(n + p for p in self._hot_positions(
                image, None if idx is None else idx[j]))
            n += len(image)
        picks = sample_positions(n, hot_pos, self.seed, self.k)
        self.k += 1
        return call, idx, picks


def flat(call: list) -> list[tuple]:
    return [k for image in call for k in image]


def sample_positions(n: int, hot_pos: list[int], seed: int,
                     k: int) -> list[int]:
    """The positions of call `k` (`n` queries, hot-name queries at
    `hot_pos`) whose answers are kept for the check: drawn from the
    seed, anywhere and among hot-name queries."""
    rng = random.Random(seed * 7919 + k)
    pick = rng.sample(range(n), min(SAMPLE_RANDOM, n))
    return pick + rng.sample(hot_pos, min(SAMPLE_HOT, len(hot_pos)))


def hot_names(gen) -> set:
    return {(sp.space, n) for sp in gen.os_spaces + gen.lang_spaces
            for n in sp.hot}


def subsample(kept: list, hot: set, seed: int) -> list:
    """At most CHECK_RANDOM of the kept answers, and CHECK_HOT more at
    hot names, drawn from the seed."""
    rng = random.Random(seed * 6133 + 1)
    at_hot = [k for k in kept if (k[0][0], k[0][1]) in hot]
    rest = [k for k in kept if (k[0][0], k[0][1]) not in hot]
    return (rng.sample(rest, min(CHECK_RANDOM, len(rest)))
            + rng.sample(at_hot, min(CHECK_HOT, len(at_hot))))


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device: str, cache: str, t_start: float, fault=None) -> Run:
    """One run of a crawl cell. `fault`, for the harness's own tests,
    rewrites each call's answers before they are kept."""
    from trivy_tpu_torch.db.store import AdvisoryDB
    from trivy_tpu_torch.detector.engine import MatchEngine, \
        queries_from_columns
    from trivy_tpu_torch.ops import match as m

    import torch

    on_card = device.startswith("cuda")
    steps = {}
    t = time.perf_counter()
    root, buckets = load_inputs(cfg, cache)
    steps["inputs_s"], t = time.perf_counter() - t, time.perf_counter()
    db = AdvisoryDB.load(root)
    steps["db_load_s"], t = time.perf_counter() - t, time.perf_counter()
    engine = MatchEngine(db, device=device, db_path=root)
    del db
    steps["engine_s"], t = time.perf_counter() - t, time.perf_counter()
    calls = Calls(cfg, traffic, buckets, seed)
    hot = calls.hot

    # one PkgQuery per key of an image: a registry's images keep theirs
    # across the calls that draw them, as a crawler keeps each image's
    # parsed package list
    made: dict[int, list] = {}

    def to_queries(image) -> list:
        return queries_from_columns(
            *[list(col) for col in zip(*image)]) if image else []

    def queries_of(call, idx) -> list:
        out: list = []
        for j, image in enumerate(call):
            if idx is None:
                out.extend(to_queries(image))
                continue
            q = made.get(idx[j])
            if q is None:
                q = made[idx[j]] = to_queries(image)
            out.extend(q)
        return out

    batch = traffic["batch_size"]
    steps["traffic_s"], t = time.perf_counter() - t, time.perf_counter()
    for c in calls.warm:
        engine.detect_many(queries_of(c, None), batch_size=batch)
    calls.warm = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps["warmup_s"] = time.perf_counter() - t
    # the reference's copy of the DB is read again after the window: the
    # harness keeps no heap of its own that the program's collector
    # would walk in the window
    del buckets
    gc.collect()

    run = Run(system="crawl", setup_s=time.perf_counter() - t_start)
    run.notes.update(steps, compile_cache=engine.build_stats.get(
        "compile_cache"))
    kept = []  # (key, MatchResult) of the sampled queries
    enc = crunch = 0.0
    pipelined = 0
    launches0 = m.match_words.launches
    seen: set[tuple] = set()
    fresh_keys: list[tuple] = []
    n_calls = 0
    prev_stats = engine.last_pipeline_stats
    prog_s = 0.0
    w0 = time.perf_counter()
    with DeviceTrace(trace) as tr:
        while prog_s < seconds:
            call, idx, picks = calls.next_call()
            qs = queries_of(call, idx)
            c0 = time.perf_counter()
            try:
                with tr.call():
                    res = engine.detect_many(qs, batch_size=batch)
                if fault is not None:
                    res = fault(res)
                if len(res) != len(qs):
                    raise RuntimeError(
                        f"{len(res)} answers for {len(qs)} queries")
            except Exception as exc:  # a failed call fails its items
                print(f"call {n_calls} failed: {exc!r}", file=sys.stderr)
                run.failed += len(qs)
                res = None
            c1 = time.perf_counter()
            prog_s += c1 - c0
            run.call_s.append(c1 - c0)
            run.attempted += len(qs)
            stats = engine.last_pipeline_stats
            if stats is not None and stats is not prev_stats:
                enc += stats["encode_busy_s"]
                crunch += stats["crunch_busy_s"]
                pipelined += 1
            prev_stats = stats
            if res is not None:
                run.done["packages"] = run.done.get("packages", 0) + len(qs)
            # an answer that never came is kept as None, and is wrong
            kept.extend((qs[i].key, None if res is None else res[i])
                        for i in picks)
            if trace:  # the roofline's input: each key once, as first sent
                for q in qs:
                    if q.key not in seen:
                        seen.add(q.key)
                        fresh_keys.append(q.key)
            n_calls += 1
    run.window_s = prog_s
    run.notes["wall_window_s"] = time.perf_counter() - w0
    run.trace = tr.reduce()
    run.counters = {"encode_busy_s": enc, "crunch_busy_s": crunch,
                    "pipelined_calls": pipelined, "calls": n_calls,
                    "match_launches": m.match_words.launches - launches0}
    if on_card:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        run.device_kind = torch.cuda.get_device_name(0)

    # the program's answers as advisory identities, then its state freed
    advs = engine.cdb.advisories
    got = [(key, None if r is None else sorted(
        (advs[i][0], advs[i][1], advs[i][2].vulnerability_id)
        for i in r.adv_indices)) for key, r in subsample(kept, hot, seed)]
    engine.close()
    del engine, kept, made, calls, seen
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    buckets = advisories.read_db(root)
    run.inputs = {"buckets": buckets, "fresh_keys": fresh_keys}
    judge(run, buckets, got)
    return run


def judge(run: Run, buckets: dict, got: list) -> None:
    """Hold the sampled answers `got` [(key, identities, or None where
    the call failed)] to the plain reference: the run's one check counts
    the answers that differ or never came."""
    from portbench.reference.crawl import CrawlReference

    ref = CrawlReference(buckets)
    wrong = sum(ids is None or ref.answer(key) != ids for key, ids in got)
    run.checks = [Check("answers_wrong", wrong, 0)]
    run.notes["answers_checked"] = len(got)


def control(cfg: dict, traffic: dict, seed: int, seconds: float,
            n_calls: int, cache: str) -> Run:
    """The control at the cell's size: the lossy reference answers the
    queries a run of `n_calls` calls would check, and is judged as the
    program is."""
    from portbench.reference.crawl import CrawlReference

    _root, buckets = load_inputs(cfg, cache)
    calls = Calls(cfg, traffic, buckets, seed)
    kept = []
    for _k in range(n_calls):
        call, _idx, picks = calls.next_call()
        keys = flat(call)
        kept.extend((keys[i], None) for i in picks)
    lossy = CrawlReference(buckets, lossy=True)
    got = [(key, lossy.answer(key))
           for key, _ in subsample(kept, calls.hot, seed)]
    run = Run(system="crawl")
    judge(run, buckets, got)
    return run

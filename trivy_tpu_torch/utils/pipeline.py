"""Generic bounded worker pipeline (reference pkg/parallel/pipeline.go:28
NewPipeline/Do: N workers over an item channel with a result callback).
Threads, not asyncio: the work units (file IO, YAML parse, regex) release
the GIL often enough, and the device batch calls serialize anyway.

Copy of trivy_tpu/utils/pipeline.py. The fleet scan mode
(`cli/fleet.py`) runs its artifacts through it."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, TypeVar

T = TypeVar("T")
R = TypeVar("R")

DEFAULT_WORKERS = 5  # reference pkg/parallel/pipeline.go:10


class PipelineError(Exception):
    """Aggregate of every failed pipeline slot, index-matched to the
    input order — no worker error is silently dropped."""

    def __init__(self, failures: list[tuple[int, Exception]], total: int):
        self.failures = failures
        detail = "; ".join(f"item {i}: {e}" for i, e in failures[:8])
        if len(failures) > 8:
            detail += f"; ... {len(failures) - 8} more"
        super().__init__(
            f"{len(failures)}/{total} pipeline items failed: {detail}")


def run_pipeline(items: Iterable[T], fn: Callable[[T], R],
                 on_result: Callable[[R], None] | None = None,
                 workers: int = DEFAULT_WORKERS,
                 on_start: Callable[[int, T], None] | None = None) -> list[R]:
    """Run fn over items with a bounded worker pool; results are returned
    in input order. on_result (if given) is called serially, in order —
    the reference's onItem callback contract.

    on_start (if given) fires from the worker the moment it picks an
    item up, BEFORE fn — the hook the fleet-scan journal uses to write
    its `running` checkpoint (so a kill mid-item is distinguishable
    from a kill before the item started). It may be called concurrently
    across workers; the callback must be thread-safe. An on_start error
    counts as the item's failure and fn is skipped.

    Worker errors do not vanish: on_result is skipped for failed slots
    and all failures surface together as one index-matched
    PipelineError after the successful slots' callbacks have been
    delivered. In parallel mode every item still runs (the pool drains
    the queue regardless); sequential mode stays fail-fast.

    Observability: the submitting thread's trace context (current span,
    scan id) is captured once and adopted inside every worker, so spans
    opened by fn attach to the submitting scan's span instead of
    becoming orphaned roots (docs/observability.md)."""
    from trivy_tpu_torch.obs import tracing

    items = list(items)
    results: list = [None] * len(items)
    errors: list = [None] * len(items)
    ran = len(items)  # slots actually attempted (sequential fail-fast)

    if workers <= 1 or len(items) <= 1:
        # sequential mode keeps fail-fast (no worker pool is draining
        # anyway): stop at the first error instead of burning the
        # remaining items' cost, but surface it as the same aggregate
        # exception type the parallel path raises
        for i, it in enumerate(items):
            try:
                if on_start:
                    on_start(i, it)
                results[i] = fn(it)
            except Exception as e:
                errors[i] = e
                ran = i + 1
                break
    else:
        q: queue.Queue = queue.Queue()
        for i, it in enumerate(items):
            q.put((i, it))
        # captured in the submitting thread, adopted per worker: a new
        # thread starts from an empty contextvars context, which is how
        # worker spans used to orphan into separate roots
        trace_ctx = tracing.capture()

        def worker():
            with tracing.adopt(trace_ctx):
                while True:
                    try:
                        i, it = q.get_nowait()
                    except queue.Empty:
                        return
                    try:
                        if on_start:
                            on_start(i, it)
                        results[i] = fn(it)
                    # BaseException too (InjectedKill, SystemExit from
                    # fn): letting it kill the worker thread would
                    # strand queued items and hang q.join() forever —
                    # in a pool, every failure must land in a slot, not
                    # take the pool down
                    except BaseException as e:  # noqa: B036  # lint: allow[bare-except] stored per-slot, aggregated into PipelineError on the submitting thread
                        errors[i] = e
                    finally:
                        q.task_done()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(workers, len(items)))]
        for t in threads:
            t.start()
        q.join()

    if on_result:
        for i in range(ran):
            if errors[i] is None:  # failed/unran slots explicitly skipped
                on_result(results[i])
    failures = [(i, e) for i, e in enumerate(errors) if e is not None]
    if failures:
        raise PipelineError(failures, len(items))
    return results

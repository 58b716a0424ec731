"""encode_busy_share.crawl: the engine's encode lane busy seconds
(`MatchEngine.last_pipeline_stats["encode_busy_s"]`, summed over the
window's pipelined calls) over the window's seconds. Nothing where no
call took the pipelined path."""


def read(run):
    if not run.counters.get("pipelined_calls") or run.window_s <= 0:
        return None
    return run.counters["encode_busy_s"] / run.window_s

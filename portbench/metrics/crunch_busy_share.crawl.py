"""crunch_busy_share.crawl: the engine's crunch lanes' busy seconds
(decode, sort-dedupe, rescreen: `last_pipeline_stats["crunch_busy_s"]`,
summed over the window's pipelined calls; lanes run in parallel, so it
may pass 1) over the window's seconds."""


def read(run):
    if not run.counters.get("pipelined_calls") or run.window_s <= 0:
        return None
    return run.counters["crunch_busy_s"] / run.window_s

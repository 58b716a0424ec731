"""chunk_share.secret: the scanner's chunking and screen-dispatch
seconds over the window (`SecretScanner.device_stats["chunk_s"]`, its
change across the window) over the window's seconds. Nothing where the
counter did not move (the stream path does not add to it)."""


def read(run):
    d = run.counters.get("chunk_s", 0.0)
    return None if d <= 0 or run.window_s <= 0 else d / run.window_s

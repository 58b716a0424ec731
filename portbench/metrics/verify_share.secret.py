"""verify_share.secret: the scanner's verification seconds over the
window (`SecretScanner.device_stats["verify_s"]`, its change across the
window) over the window's seconds. Nothing where the counter did not
move (the stream path does not add to it)."""


def read(run):
    d = run.counters.get("verify_s", 0.0)
    return None if d <= 0 or run.window_s <= 0 else d / run.window_s

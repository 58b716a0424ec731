"""secret_mb_per_s: bytes of every file scanned in the window, in MB
(10**6 bytes), over the window's seconds."""


def read(run):
    n = run.done.get("file_bytes")
    return None if n is None or run.window_s <= 0 else n / 1e6 / run.window_s

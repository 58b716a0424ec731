"""pkg_per_s: package queries answered in the window over the window's
seconds, every call's work and all of the window's time."""


def read(run):
    n = run.done.get("packages")
    return None if n is None or run.window_s <= 0 else n / run.window_s

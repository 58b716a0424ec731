"""screen_roofline.secret: the least time the window's secret screen
needs over the time every CUDA kernel of the traced window took, in %.
The work is counted from the cell's inputs (`lib/roofline.py`
`screen_bytes`: the window's file bytes once, plus one bit a built-in
rule for each 16 KiB of them out) over the card's published HBM
bandwidth."""

from portbench.lib import peaks, roofline
from portbench.reference.secret_rules import BUILTIN_RULES


def read(run):
    t = run.trace
    n = run.inputs.get("file_bytes")
    if not t or not t["kernel_s"] or not n or not run.device_kind:
        return None
    need = roofline.screen_bytes(n, len(BUILTIN_RULES))
    return 100.0 * need / peaks.hbm_bytes_per_s(run.device_kind) \
        / t["kernel_s"]

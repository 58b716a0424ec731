"""match_roofline.crawl: the least time the window's match work needs
over the time every CUDA kernel of the traced window took, in %. The
work is counted from the cell's inputs (`lib/roofline.py`
`match_bytes`: each (space, name) group the window's fresh queries
touch read once at 16 B an advisory interval, 16 B a query in, 4 B a
query out) over the card's published HBM bandwidth."""

from portbench.lib import peaks, roofline


def read(run):
    t = run.trace
    keys = run.inputs.get("fresh_keys")
    if not t or not t["kernel_s"] or not keys or not run.device_kind:
        return None
    need = roofline.match_bytes(run.inputs["buckets"], keys)
    return 100.0 * need / peaks.hbm_bytes_per_s(run.device_kind) \
        / t["kernel_s"]

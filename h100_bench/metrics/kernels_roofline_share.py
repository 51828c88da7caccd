"""The hand kernels' share of their roofline on one captured step of the
cell's first batch (every tier and shard 0), taken after the window: the
sum of the kernels' least times (yardstick/work.py, against the peaks in
yardstick/peaks.py) over the sum of their device times (torch.profiler,
mean of five replays of each captured call).  A kernel with no count,
or whose count is not of distinct bytes (roofline.UNCOUNTED), is listed
on the log and left out of both sums."""

LAYER = "hand kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def probe(ctx):
    from h100_bench.yardstick.roofline import measure
    return measure(ctx)


def read(w):
    r = w.extra.get("probe", {}).get("kernels_roofline_share")
    if not r or r["device_ms"] <= 0:
        return None
    return 100.0 * r["bound_ms"] / r["device_ms"]

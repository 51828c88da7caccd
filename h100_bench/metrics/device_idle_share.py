"""The share of the window in which no operation ran on the card: 1 less
the union of the device events' intervals (torch.profiler) over the
window."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"
PROFILE = True


def read(w):
    d = w.extra.get("device")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])

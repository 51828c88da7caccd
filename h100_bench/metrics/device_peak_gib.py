"""The card's peak of allocated memory over the run
(torch.cuda.max_memory_allocated), in GiB."""

LAYER = "device"
UNIT = "GiB"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(w):
    b = w.extra.get("memory_peak_bytes")
    return b / 2 ** 30 if b else None

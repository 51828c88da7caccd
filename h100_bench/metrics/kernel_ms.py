"""Device ms a batch in the program's hand-written kernels (the
__global__ functions of hisat2_tpu_torch/csrc), from the profiler's
trace of the window."""

LAYER = "hand kernels"
UNIT = "ms/batch"
SOURCE = "device_trace"
MOVES = "reads_per_s"
PROFILE = True


def read(w):
    d = w.extra.get("device")
    if not d or not d["hand_s"]:
        return None
    return w.per_batch_ms(d["hand_s"])

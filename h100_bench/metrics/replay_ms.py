"""Host ms a batch in the CLI's per-read replay of search-path-sensitive
reads (align/hybrid.py:substitute_batch), called from the driver's emit."""

LAYER = "driver and replay"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.hybrid", "substitute_batch", "replay")]


def read(w):
    return w.per_batch_ms(w.total("replay"))

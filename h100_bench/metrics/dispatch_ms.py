"""Host ms a batch enqueuing device steps (TorchAligner.dispatch and the
step it launches), on the host's clock."""

LAYER = "device step enqueue"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner.dispatch",
          "dispatch")]


def read(w):
    return w.per_batch_ms(w.total("dispatch"))

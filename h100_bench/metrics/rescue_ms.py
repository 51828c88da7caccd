"""Host ms a batch in mate rescue (TorchAligner.rescue_mates: its window
jobs, K12 and K5 on the card, and the rescued alignments)."""

LAYER = "mate rescue"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner.rescue_mates",
          "rescue")]


def read(w):
    return w.per_batch_ms(w.total("rescue"))

"""Host ms a batch in TorchAligner.collect: the wait for the device, the
shard merge, the host phase, a two-tier aligner's remaining stages and
the temp-site fixed point."""

LAYER = "collect"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner.collect",
          "collect")]


def read(w):
    return w.per_batch_ms(w.total("collect"))

"""Host ms a batch in the driver's pairing (align/driver.py:
_align_pair_batch, with align/paired.py's best_pairs and the per-pair
finalize), less the collect, mate rescue and render calls inside it."""

LAYER = "pairing"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.driver", "_align_pair_batch",
          "pair_batch"),
         ("hisat2_tpu_torch.align.pipeline", "TorchAligner.collect",
          "collect"),
         ("hisat2_tpu_torch.align.pipeline", "TorchAligner.rescue_mates",
          "rescue"),
         ("hisat2_tpu_torch.io.sam", "SamWriter.write_pair", "render")]


def read(w):
    return w.per_batch_ms(w.self_time("pair_batch"))

"""Host ms a batch in TorchAligner._merge_shards: the wait for each
shard's packed output, its copy to the host and the merge into global
coordinates."""

LAYER = "shards"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner._merge_shards",
          "shard_merge")]


def read(w):
    return w.per_batch_ms(w.total("shard_merge"))

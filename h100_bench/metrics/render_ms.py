"""Host ms a batch rendering SAM: io/sam.py's SamWriter.write_batch_raw
(unpaired, with its per-read finalize) or SamWriter.write_pair (each
pair)."""

LAYER = "SAM render"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.io.sam", "SamWriter.write_batch_raw",
          "render"),
         ("hisat2_tpu_torch.io.sam", "SamWriter.write_pair", "render")]


def read(w):
    return w.per_batch_ms(w.total("render"))

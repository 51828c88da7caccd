"""Host ms a batch in align/host.py:read_alignments, the per-read lookup
of a read's alignments that the unpaired render's finalize calls (each
call builds a list per read up to its own, so a batch costs O(B^2))."""

LAYER = "SAM render"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.host", "read_alignments", "materialize")]


def read(w):
    return w.per_batch_ms(w.total("materialize"))

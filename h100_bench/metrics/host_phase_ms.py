"""Host ms a batch in the NumPy host phase (align/host.py:
HostPhase._host_phase), wherever it runs: collect, a two-tier aligner's
advance, the fixed point's re-runs."""

LAYER = "host phase"
UNIT = "ms/batch"
SOURCE = "program_span"
MOVES = "reads_per_s"
HOOKS = [("hisat2_tpu_torch.align.host", "HostPhase._host_phase",
          "host_phase")]


def read(w):
    return w.per_batch_ms(w.total("host_phase"))

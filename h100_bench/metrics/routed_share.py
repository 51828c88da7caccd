"""The share of a two-tier aligner's reads that its lite pass routes to
the full pass (TorchAligner._route_two_pass: the routed reads over the
batch's reads)."""

LAYER = "two-tier routing"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def _after(add, state, args, kwargs, result):
    add("routed", int(len(result)))
    add("route_reads", int(len(args[1][0])))


HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner._route_two_pass",
          "route", None, _after)]


def read(w):
    n = w.count("route_reads")
    return 100.0 * w.count("routed") / n if n else None

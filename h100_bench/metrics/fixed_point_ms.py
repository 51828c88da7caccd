"""Host ms a batch in the splice-site DB's temp-site fixed point: the
program's own counter TorchAligner.fixed_point_s (the full pass re-run
while a batch's alignments add sites), read across each collect call."""

LAYER = "splice-site DB"
UNIT = "ms/batch"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def _before(args, kwargs):
    return getattr(args[0], "fixed_point_s", None)


def _after(add, before, args, kwargs, result):
    now = getattr(args[0], "fixed_point_s", None)
    if before is not None and now is not None:
        add("fixed_point_s", now - before)


HOOKS = [("hisat2_tpu_torch.align.pipeline", "TorchAligner.collect",
          "collect", _before, _after)]


def read(w):
    if not any(k == "fixed_point_s" for _, k, _ in w.events):
        return None
    return w.per_batch_ms(w.count("fixed_point_s"))

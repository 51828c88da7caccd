"""One captured device step of the cell's first batch, its kernels counted
against the card's roofline (work.py) and timed on the card.

Runs after the window on the aligner the timed call built: each tier of
it (a two-tier aligner's lite pass, then its full pass) steps shard 0
once with capture, and each captured kernel call is replayed five times
under torch.profiler; its device time is the mean of the hand kernels'
events over those replays.
"""

from __future__ import annotations

import numpy as np

from h100_bench.tracing.device import hand_kernel_names

REPLAYS = 5
# kernels whose count in work.py is not one of bytes each read once, and
# which on an H100 gave least times near or above their device times: the
# FM search counts every row fetch (a row that many lanes fetch counts
# each time: 2.3x at the linear step), the reference windows every
# window's words (a lane's candidates' windows overlap: 1.06-2.1x), the
# sampled-SA walk every walk's fetches (walks share rows: 1.1x), the site
# injection the site tables whole (0.89-1.10x); left out until they count
# distinct bytes
UNCOUNTED = {"fm_search2", "search_lanes_live", "ref_window",
             "resolve_walk", "inject_known"}


def _device_ms(torch, fn, kw, pat):
    """Mean device ms of the hand kernels of one call, over REPLAYS
    calls in one profiler session; a session that recorded none of them
    (the profiler can drop the first events of a session that follows
    another) is tried once more, and then gives 0."""
    from torch.profiler import ProfilerActivity, profile
    fn(**kw)
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(REPLAYS):
                fn(**kw)
            torch.cuda.synchronize()
        ns = sum(e.duration_ns() for e in p.profiler.kineto_results.events()
                 if e.device_type().name == "CUDA" and pat.search(e.name()))
        if ns:
            break
    return ns * 1e-6 / REPLAYS


def measure(ctx):
    import re
    torch, al, log = ctx.torch, ctx.aligner, ctx.log
    if al is None or ctx.device != "cuda":
        return None
    from hisat2_tpu_torch.ops import kernel_twins

    from .work import work
    twins = kernel_twins()
    pat = re.compile("|".join(re.escape(k) for k in
                              hand_kernel_names(ctx.repo)))
    codes, quals, lens, rdids = ctx.first_batch()
    tiers = [al] + ([al._fast] if getattr(al, "_fast", None) is not None
                    else [])
    rows, bound, dev = [], 0.0, 0.0
    for tier, a in zip(("full" if len(tiers) > 1 else "step", "lite"),
                       tiers):
        cap = {}
        minsc = a._minsc(lens)
        uniform = bool(np.all(lens == codes.shape[1]))
        rd, ss = a._step_site_args(rdids, 0)
        a.step(*a.upload(codes, quals, lens, minsc), uniform, capture=cap,
               rdids=rd, ss=ss, shard=0)
        torch.cuda.synchronize()
        for key, kw in cap.items():
            name = key.split("/")[0]
            if name in UNCOUNTED:
                log(f"[roofline] {tier} {key}: its count is not of "
                    f"distinct bytes; left out")
                continue
            kern = twins[name][0]
            out = kern(**kw)
            torch.cuda.synchronize()
            try:
                b, what = work(torch, name, kw, out)
            except Exception as e:                  # noqa: BLE001
                log(f"[roofline] {tier} {key}: no work count ({e!r}); "
                    f"left out")
                continue
            t = _device_ms(torch, kern, kw, pat)
            if t <= 0:
                log(f"[roofline] {tier} {key}: no device time recorded; "
                    f"left out")
                continue
            rows.append([f"{tier}:{key}", b, t, what])
            bound += b
            dev += t
            log(f"[roofline] {tier} {key}: bound {b:.4f} ms ({what}), "
                f"device {t:.4f} ms, share {100 * b / t:.2f}%")
    return dict(bound_ms=bound, device_ms=dev, rows=rows)

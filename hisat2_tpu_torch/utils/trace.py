"""Per-phase wall-clock tracing (reference analog: PerfMetrics'
per-phase counters printed under -t / --met-stderr, hisat2.cpp metrics
plumbing; here an env-gated section tracer usable in any host phase).

Enable with HISAT2_TPU_TRACE=<tag>[,<tag>...] or HISAT2_TPU_TRACE=all.
Each traced region prints one stderr line per call:

    [trace host_phase] unpack 3.1ms policy 2.0ms ... total 101.2ms

Zero overhead when the env var is unset (the tick function is a no-op
lambda resolved once per call site).

Copied verbatim from hisat2_tpu/utils/trace.py; only the imports are
rewritten, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import sys
import time

_SPEC = os.environ.get("HISAT2_TPU_TRACE", "")
_TAGS = {t.strip() for t in _SPEC.split(",") if t.strip()}


def enabled(tag: str) -> bool:
    return "all" in _TAGS or tag in _TAGS


def section_timer(tag: str):
    """Returns tick(name); call tick() with section names as the code
    passes section boundaries, and tick(None) at the end to emit."""
    if not enabled(tag):
        return lambda name=None: None
    t = [time.perf_counter()]
    parts = []

    def tick(name=None):
        now = time.perf_counter()
        if name is None:
            total = sum(p[1] for p in parts)
            msg = " ".join(f"{n} {ms * 1e3:.1f}ms" for n, ms in parts)
            print(f"[trace {tag}] {msg} total {total * 1e3:.1f}ms",
                  file=sys.stderr, flush=True)
        else:
            parts.append((name, now - t[0]))
        t[0] = now
    return tick

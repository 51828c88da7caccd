"""The device's side of a traced run: torch.profiler over the timed call,
the kernel intervals put on the host's clock, and the busy time, the
hand kernels' time and the longest idle gaps inside the window."""

from __future__ import annotations

import glob
import os
import re
import time


def hand_kernel_names(repo: str) -> list:
    """The __global__ functions of the program's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(repo, "hisat2_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+(?:void\s+)?"
                                    r"(?:__launch_bounds__\([^)]*\)\s+)?"
                                    r"(?:void\s+)?(\w+)\s*\(", f.read()))
    return sorted(names)


class DeviceTrace:
    """Start before the timed call, stop after it; `read` takes the
    window's numbers."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.note = None

    def start(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        x = torch.empty(1 << 16, device="cuda")
        # a first, discarded session: the profiler can drop the first
        # events of the first session in a process
        with profile(activities=[ProfilerActivity.CUDA]):
            x.fill_(0.0)
            torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        # a marker kernel, the first device event of the trace: its end
        # on the host's clock gives the trace's offset
        torch.cuda.synchronize()
        x.fill_(1.0)
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def _events(self):
        """[(name, start_s, end_s)] of the device events, on the host's
        clock."""
        res = self.prof.profiler.kineto_results
        ev = []
        for e in res.events():
            if e.device_type().name != "CUDA":
                continue
            s = e.start_ns() * 1e-9
            ev.append((e.name(), s, s + e.duration_ns() * 1e-9))
        ev.sort(key=lambda x: x[1])
        if not ev:
            return []
        if "fill" not in ev[0][0].lower():
            self.note = (f"[trace] the trace's first device event is "
                         f"{ev[0][0][:60]!r}, not the marker; the window's "
                         f"device times may be shifted")
        off = self.t_marker - ev[0][2]
        return [(n, a + off, b + off) for n, a, b in ev[1:]]

    def read(self, t0, t1, kernel_names):
        ev = [(n, max(a, t0), min(b, t1)) for n, a, b in self._events()
              if b > t0 and a < t1]
        busy, end, gaps = 0.0, t0, []
        by_name, hand = {}, 0.0
        pat = re.compile("|".join(re.escape(k) for k in kernel_names)) \
            if kernel_names else None
        for n, a, b in ev:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
            if pat is not None and pat.search(n):
                hand += b - a
            if a > end:
                gaps.append((a - end, end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if t1 > end:
            gaps.append((t1 - end, end, t1))
        return dict(busy_s=busy, window_s=t1 - t0, n_events=len(ev),
                    hand_s=hand, by_name=by_name, gaps=gaps)

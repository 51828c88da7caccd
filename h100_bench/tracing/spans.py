"""Spans and counters from wrappers around the program's calls.

Only a traced run (--trace 1) installs them.  A metric's file names the
calls it reads as HOOKS: (module, attribute path, span name, before,
after).  The wrapper records a span (name, start, end, parent) for every
call and hands `before(args, kwargs)`'s value and the call's result to
`after(add, state, args, kwargs, result)`, which adds to counters.  A
layer's self time is its span's length less the part its child spans
cover.
"""

from __future__ import annotations

import importlib
import inspect
import time


class Tracer:
    def __init__(self, log):
        self.log = log
        self.spans = []          # [name, t0, t1, parent index or -1]
        self.events = []         # (t, counter, value)
        self._stack = []
        self._patched = {}       # (owner id, attr) -> (owner, attr, orig)
        self._hooks = {}         # (module, path) -> [(span, before, after)]

    def add(self, key, value):
        self.events.append((time.perf_counter(), key, value))

    def hook(self, module, path, span, before=None, after=None):
        self._hooks.setdefault((module, path), []).append(
            (span, before, after))

    def install(self):
        """Wrap every hooked call; a missing module or attribute is left
        out with a line on the log (its metrics then read nothing)."""
        missing = []
        for (module, path), hooks in self._hooks.items():
            try:
                owner = importlib.import_module(module)
                parts = path.split(".")
                for p in parts[:-1]:
                    owner = getattr(owner, p)
                raw = inspect.getattr_static(owner, parts[-1])
            except (ImportError, AttributeError) as e:
                missing.append(f"{module}.{path} ({e})")
                continue
            self._wrap(owner, parts[-1], raw, hooks)
        for m in missing:
            self.log(f"[trace] not wrapped, its metrics left out: {m}")
        return missing

    def _wrap(self, owner, attr, raw, hooks):
        kind = type(raw)
        fn = raw.__func__ if kind in (staticmethod, classmethod) else raw
        tracer = self
        names = [h[0] for h in hooks]

        def wrapper(*args, **kwargs):
            states = [b(args, kwargs) if b else None for _, b, _ in hooks]
            parent = tracer._stack[-1] if tracer._stack else -1
            idx = len(tracer.spans)
            tracer.spans.append([names[0], time.perf_counter(), None,
                                 parent])
            tracer._stack.append(idx)
            try:
                result = fn(*args, **kwargs)
            finally:
                tracer._stack.pop()
                tracer.spans[idx][2] = time.perf_counter()
            for (_, _, after), st in zip(hooks, states):
                if after:
                    after(tracer.add, st, args, kwargs, result)
            return result

        wrapper.__wrapped__ = fn
        new = kind(wrapper) if kind in (staticmethod, classmethod) else \
            wrapper
        self._patched[(id(owner), attr)] = (owner, attr, raw)
        setattr(owner, attr, new)

    def uninstall(self):
        for owner, attr, raw in self._patched.values():
            setattr(owner, attr, raw)
        self._patched.clear()


class Window:
    """The spans and counters of one window [t0, t1], as metrics read
    them.  A span counts where it ends inside the window.  `batches` is
    the number of batches whose records arrived in the window (a
    two-tier aligner collects each batch once a tier, so the program's
    collect calls do not count batches)."""

    def __init__(self, tracer, t0, t1, batches, extra=None):
        self.t0, self.t1 = t0, t1
        self.batches = batches
        self.spans = tracer.spans if tracer else []
        self.events = tracer.events if tracer else []
        self.extra = extra or {}
        self._kids = None

    def _in(self, s):
        return s[2] is not None and self.t0 <= s[2] <= self.t1

    def _top(self, i):
        """Whether span i has no ancestor of its own name."""
        name, p = self.spans[i][0], self.spans[i][3]
        while p >= 0:
            if self.spans[p][0] == name:
                return False
            p = self.spans[p][3]
        return True

    def calls(self, name):
        return [i for i, s in enumerate(self.spans)
                if s[0] == name and self._in(s) and self._top(i)]

    def total(self, name):
        """Seconds in the top-level spans of `name` in the window, or
        None where there is none."""
        c = self.calls(name)
        if not c:
            return None
        return sum(self.spans[i][2] - self.spans[i][1] for i in c)

    def self_time(self, name):
        """Seconds of the spans of `name` less their child spans."""
        if self._kids is None:
            self._kids = {}
            for i, s in enumerate(self.spans):
                if s[3] >= 0 and s[2] is not None:
                    self._kids.setdefault(s[3], []).append(i)
        c = self.calls(name)
        if not c:
            return None
        tot = 0.0
        for i in c:
            t0, t1 = self.spans[i][1], self.spans[i][2]
            cover = sorted((self.spans[k][1], self.spans[k][2])
                           for k in self._kids.get(i, ()))
            busy, end = 0.0, t0
            for a, b in cover:
                a = max(a, end)
                if b > a:
                    busy += b - a
                    end = b
            tot += (t1 - t0) - busy
        return tot

    def per_batch_ms(self, seconds):
        if seconds is None or not self.batches:
            return None
        return 1e3 * seconds / self.batches

    def count(self, key):
        return sum(v for t, k, v in self.events
                   if k == key and self.t0 <= t <= self.t1)

    def active_at(self, t):
        """The innermost span open at host time t, or None."""
        best = None
        for s in self.spans:
            if s[1] <= t and (s[2] is None or s[2] >= t):
                if best is None or s[1] >= best[1]:
                    best = s
        return best[0] if best else None

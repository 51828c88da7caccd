"""One run of one cell: set-up, the measured window, the check, the
result line.

The window drives the program's `align` command itself
(hisat2_tpu_torch.cli.align.main, which runs align/driver.py:run_align)
in this process, with the arguments a user gives.  Reads reach it
through FIFOs fed from pre-formatted FASTQ bytes; its SAM goes to a FIFO
that a reader thread drains, stamping each chunk with the host's clock.
The window opens when the first SAM record arrives and closes `seconds`
later, when the feeder closes the input; the program then finishes the
reads it holds, and every record is checked against the plain
reference.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import select
import shutil
import sys
import tempfile
import threading
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hisat2_tpu")
CHUNK = 1 << 18


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_entry(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name} in BENCHMARK.json")


def cell_metrics(man, cell):
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose moved metric the cell reports."""
    e2e = {m["name"]: m for m in man["end_to_end"]}
    out = []
    for m in man["per_layer"]:
        wl = m.get("workloads")
        if wl is not None:
            if cell in wl:
                out.append(m["name"])
        else:
            moved = e2e.get(m["moves"], {})
            if cell in moved.get("workloads", [cell]):
                out.append(m["name"])
    return out


def load_workload(name):
    with open(os.path.join(HERE, "workloads", name + ".json")) as f:
        return json.load(f)


def make_traffic(gen, dep, wl, seed):
    """The cell's pool of reads for one seed.  Where the workload names a
    `pool_seed`, the pool is drawn from it, the same for every seed, and
    the seed orders it: every run does the same work, in another order."""
    if wl.get("pool_seed") is None:
        return gen.generate(dep, wl["traffic"], seed)
    from h100_bench.traffic.reads import reorder
    return reorder(gen.generate(dep, wl["traffic"], wl["pool_seed"]), seed)


def metric_module(name):
    return importlib.import_module(f"h100_bench.metrics.{name}")


# -- the feeder and the reader ---------------------------------------------

class Stream:
    """A mate's reads as one endless FASTQ byte stream: the pool's bytes
    again and again, the k-th pass with each name raised by k times the
    pool (names stay r%09d, so read i of the stream is pool read i % n)."""

    def __init__(self, mate, n):
        self.m, self.n = mate, n
        self.size = len(mate.fastq)
        self.beg = np.concatenate([[0], mate.ends[:-1]]).astype(np.int64)
        self.passes = {0: mate.fastq}

    def _pass(self, k):
        if k not in self.passes:
            buf = np.frombuffer(self.m.fastq, np.uint8).copy()
            ids = np.arange(self.n, dtype=np.int64) + k * self.n
            for d in range(9):
                buf[self.beg + 2 + d] = ord("0") + (ids // 10 ** (8 - d)) % 10
            self.passes = {k: buf.tobytes()}
        return self.passes[k]

    def view(self, pos, upto):
        """Bytes [pos, min(upto, end of pos's pass)) of the stream."""
        k, off = divmod(pos, self.size)
        end = min(upto - k * self.size, self.size)
        return memoryview(self._pass(k))[off:end]

    def started(self, pos):
        """Records whose first byte lies below byte offset pos."""
        k, off = divmod(pos, self.size)
        return k * self.n + int(np.searchsorted(self.beg, off, "left"))

    def end_of(self, records):
        """The byte offset after the first `records` records."""
        if records <= 0:
            return 0
        k, r = divmod(records - 1, self.n)
        return k * self.size + int(self.m.ends[r])


class Feeder(threading.Thread):
    """Writes each mate's stream into its FIFO until `stop_at`, then
    completes every mate to the same whole record, closing each as it
    gets there (the program reads a batch of mate 1, then of mate 2)."""

    def __init__(self, paths, mates, n):
        super().__init__(daemon=True)
        self.streams = [Stream(m, n) for m in mates]
        self.fds = []
        for p in paths:
            # read and write: the open never waits for the program, and
            # the program sees the end of input when this fd closes
            self.fds.append(os.open(p, os.O_RDWR | os.O_NONBLOCK))
        self.pos = [0] * len(paths)
        self.stop_at = None
        self.abort = False          # the program has stopped reading
        self.fed = 0
        self.error = None

    def _write(self, i, upto):
        if self.pos[i] >= upto:
            return
        try:
            self.pos[i] += os.write(self.fds[i], self.streams[i].view(
                self.pos[i], min(upto, self.pos[i] + CHUNK)))
        except BlockingIOError:
            pass

    def run(self):
        open_ = set(range(len(self.fds)))
        try:
            while True:
                now = time.perf_counter()
                if self.abort or (self.stop_at is not None
                                  and now >= self.stop_at):
                    break
                wait = 0.05 if self.stop_at is None else max(
                    0.0, min(0.05, self.stop_at - now))
                _, ready, _ = select.select([], self.fds, [], wait)
                for i, fd in enumerate(self.fds):
                    if fd in ready:
                        self._write(i, self.pos[i] + CHUNK)
            # every mate to the same whole record
            target = max(s.started(p) for s, p in zip(self.streams,
                                                     self.pos))
            ends = [s.end_of(target) for s in self.streams]
            while open_ and not self.abort:
                for i in list(open_):
                    if self.pos[i] >= ends[i]:
                        os.close(self.fds[i])
                        open_.discard(i)
                todo = [self.fds[i] for i in open_]
                if todo:
                    select.select([], todo, [], 0.5)
                for i in list(open_):
                    self._write(i, ends[i])
            self.fed = target
        except Exception as e:                      # noqa: BLE001
            self.error = e
        finally:
            for i in open_:
                os.close(self.fds[i])


def host_load():
    """(process CPU seconds, the machine's steal seconds, this process's
    involuntary context switches): what the host took from the run."""
    import resource
    steal = float("nan")
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, steal, ru.ru_nivcsw


class Reader(threading.Thread):
    """Drains the SAM FIFO: chunks with their arrival time; calls
    `on_open(t)` when the first record's bytes arrive."""

    def __init__(self, path):
        super().__init__(daemon=True)
        self.path = path
        self.chunks = []
        self.cpu = []               # process CPU seconds at each chunk
        self.t_open = None
        self.on_open = None
        self.error = None

    def run(self):
        head = b""
        try:
            fd = os.open(self.path, os.O_RDONLY)
            while True:
                b = os.read(fd, 1 << 20)
                if not b:
                    break
                t = time.perf_counter()
                self.chunks.append((t, b))
                self.cpu.append(time.process_time())
                if self.t_open is None:
                    head += b
                    if (head[:1] not in (b"@", b"")
                            or b"\n" in head and any(
                                ln[:1] != b"@" for ln in
                                head.split(b"\n")[1:] if ln)):
                        self.t_open = t
                        if self.on_open:
                            self.on_open(t)
            os.close(fd)
        except Exception as e:                      # noqa: BLE001
            self.error = e

    def lines(self):
        """[(line, arrival time)] of the SAM records (headers left out)."""
        data = b"".join(c for _, c in self.chunks)
        ends = np.cumsum([len(c) for _, c in self.chunks])
        times = np.array([t for t, _ in self.chunks])
        lines = data.split(b"\n")
        lens = np.fromiter((len(x) + 1 for x in lines), np.int64,
                           len(lines))
        at = np.minimum(np.searchsorted(ends, np.cumsum(lens) - 1,
                                        "right"), len(times) - 1)
        return [(ln, times[at[i]]) for i, ln in enumerate(lines)
                if ln and ln[:1] != b"@"]


def batch_window(lines, t0, seconds, batch):
    """The measured window: from the first record's arrival (t0) to the
    arrival of the first record of the first batch that begins arriving
    `seconds` or more after it, so that it holds whole batches (the
    program writes a batch's records at once, in input order).  Returns
    (its end, the reads whose primary record arrived in it, batches,
    each batch's first arrival up to the end)."""
    first = {}
    prim = []
    for ln, t in lines:
        f = ln.split(b"\t", 2)
        if int(f[1]) & 0x900:
            continue
        i = int(f[0][1:])
        prim.append((i, t))
        j = i // batch
        if i % batch == 0 and j not in first:
            first[j] = t
    ends = [j for j in sorted(first) if j > 0 and first[j] >= t0 + seconds]
    if not ends:
        raise RuntimeError("no batch began arriving after the window's "
                           "length; the program stopped early")
    J = ends[0]
    t1 = first[J]
    # records come in input order: every record of an earlier batch
    # arrived by t1 (some in the same chunk as batch J's first)
    n = sum(1 for i, t in prim if i < J * batch)
    return t1, n, J, [first[j] for j in sorted(first) if j <= J]


# -- the run ---------------------------------------------------------------

def _argv(cfg, wl, base, inputs, sam, device):
    a = ["-x", base, "-q", "-S", sam, "--device", device]
    if len(inputs) == 2:
        a += ["-1", inputs[0], "-2", inputs[1]]
    else:
        a += ["-U", inputs[0]]
    return a + list(cfg.get("align_args", [])) + list(
        wl.get("align_args", []))


def _align(argv):
    from hisat2_tpu_torch.cli.align import main as align_main
    rc = align_main(argv)
    if rc != 0:
        raise RuntimeError(f"align {' '.join(argv)} returned {rc}")


def run(cell, seed, seconds, trace, device="cuda", t_start=None,
        faults=None, manifest=None, workload=None, config=None, cache=None):
    """One run; returns (exit code, the result dict or None).  faults:
    a callable run before the window, for the tests that break the timed
    path underneath."""
    from h100_bench import deploy
    from h100_bench.reference import judge
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest or load_manifest()
    entry = cell_entry(man, cell)
    wl = workload or load_workload(cell)
    cfg = config or deploy.load_config(entry["config"])
    names = cell_metrics(man, cell) if trace else []
    mods = {n: metric_module(n) for n in names}
    import torch
    cuda = device == "cuda"

    # set-up: the deployment, the index (built once per checkout), reads
    t0 = time.perf_counter()
    dep = deploy.make(cfg)
    t_dep = time.perf_counter() - t0
    base, t_build = deploy.ensure_index(dep, cache or deploy.CACHE, log)
    gen = importlib.import_module(
        f"h100_bench.traffic.{wl['generator']}")
    t0 = time.perf_counter()
    traffic = make_traffic(gen, dep, wl, seed)
    warm = gen.generate(dep, wl["traffic"], seed ^ 0x5A5A5A5A,
                        n=wl["warmup"])
    t_gen = time.perf_counter() - t0
    log(f"[setup] deployment {t_dep:.2f} s, reads {t_gen:.2f} s "
        f"({traffic.n} {'pairs' if traffic.paired else 'reads'} pooled)")
    tmp = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        # warm-up: the same command on the cell's own shapes
        t0 = time.perf_counter()
        wins = []
        for k, m in enumerate(warm.mates):
            p = os.path.join(tmp, f"warm{k + 1}.fq")
            with open(p, "wb") as f:
                f.write(m.fastq)
            wins.append(p)
        _align(_argv(cfg, wl, base, wins, os.devnull, device))
        if cuda:
            torch.cuda.synchronize()
        log(f"[setup] warm-up run of {warm.n} in "
            f"{time.perf_counter() - t0:.2f} s")
        if faults is not None:
            faults()

        tracer = aligners = dev_trace = None
        if trace:
            from h100_bench.tracing.spans import Tracer
            tracer = Tracer(log)
            for n, mod in mods.items():
                for h in getattr(mod, "HOOKS", ()):
                    tracer.hook(*h)
            aligners = []
            from hisat2_tpu_torch.align import pipeline
            orig_init = pipeline.TorchAligner.__init__

            def keep(self, *a, **k):
                orig_init(self, *a, **k)
                aligners.append(self)
            pipeline.TorchAligner.__init__ = keep
            tracer.install()
            if cuda and any(getattr(m, "PROFILE", False)
                            for m in mods.values()):
                from h100_bench.tracing.device import DeviceTrace
                dev_trace = DeviceTrace(torch)
                dev_trace.start()

        # the timed call
        ins = [os.path.join(tmp, f"in{k + 1}.fq")
               for k in range(len(traffic.mates))]
        sam = os.path.join(tmp, "out.sam")
        for p in ins + [sam]:
            os.mkfifo(p)
        feeder = Feeder(ins, traffic.mates, traffic.n)
        reader = Reader(sam)
        win = {}

        def opened(t):
            win["t0"] = t
            win["load0"] = host_load()
            feeder.stop_at = t + seconds
        reader.on_open = opened
        reader.start()
        feeder.start()
        err = None
        try:
            _align(_argv(cfg, wl, base, ins, sam, device))
        except BaseException as e:                  # noqa: BLE001
            err = e
            try:
                os.close(os.open(sam, os.O_WRONLY | os.O_NONBLOCK))
            except OSError:
                pass
            feeder.abort = True
        if cuda:
            torch.cuda.synchronize()
        feeder.join()
        reader.join()
        if trace:
            tracer.uninstall()
            pipeline.TorchAligner.__init__ = orig_init
            if dev_trace is not None:
                dev_trace.stop()
        if err is not None:
            raise err
        for th in (feeder, reader):
            if th.error is not None:
                raise th.error
        if "t0" not in win:
            raise RuntimeError("the timed call wrote no SAM record")
        lines = reader.lines()
        w0 = win["t0"]
        w1, in_win, n_batches, starts = batch_window(
            lines, w0, seconds, int(wl.get("batch_size", 4096)))
        load1 = host_load()
        ts = np.array([t for t, _ in reader.chunks])
        cpu_win = (reader.cpu[int(np.searchsorted(ts, w1))]
                   - reader.cpu[int(np.searchsorted(ts, w0))])
        log(f"[window] batch s: " + " ".join(
            f"{b - a:.3f}" for a, b in zip(starts, starts[1:])))
        log(f"[window] process CPU {cpu_win:.3f} s in {w1 - w0:.3f} s; "
            f"to the run's end: machine steal "
            f"{load1[1] - win['load0'][1]:.2f} s, involuntary switches "
            f"{load1[2] - win['load0'][2]}")
        setup_s = w0 - t_start
        mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        log(f"[window] {n_batches} batches, {in_win} reads in "
            f"{w1 - w0:.3f} s")

        metrics = {}
        if not trace:
            metrics["reads_per_s"] = {"value": in_win / (w1 - w0),
                                      "unit": "reads/s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": (torch.cuda.get_device_name(0) if cuda else "cpu"),
               "count": 1, "memory_peak_bytes": mem_peak}
        breakdown = None
        if trace:
            from h100_bench.tracing.spans import Window
            extra = {"memory_peak_bytes": mem_peak or None}
            if dev_trace is not None:
                from h100_bench.tracing.device import hand_kernel_names
                d = dev_trace.read(w0, w1, hand_kernel_names(REPO))
                if dev_trace.note:
                    log(dev_trace.note)
                extra["device"] = d
                dev["busy_s"] = d["busy_s"]
                dev["window_s"] = d["window_s"]
            # what a metric's probe sees after the window
            ctx = types.SimpleNamespace(
                torch=torch, device=device, repo=REPO, log=log,
                aligner=aligners[-1] if aligners else None,
                first_batch=lambda: _first_batch(wl, traffic))
            extra["probe"] = {}
            for n, mod in mods.items():
                if hasattr(mod, "probe"):
                    extra["probe"][n] = mod.probe(ctx)
            w = Window(tracer, w0, w1, n_batches, extra)
            for n, mod in mods.items():
                v = mod.read(w)
                if v is None:
                    log(f"[trace] {n}: nothing to read in this cell; "
                        f"left out")
                    continue
                metrics[n] = {"value": float(v), "unit": mod.UNIT}
            if "device" in extra:
                breakdown = _breakdown(extra["device"], w)
            del ctx, aligners
        del tracer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the check, once the window has closed
        t0 = time.perf_counter()
        checks, attempted, failed = judge.judge(
            dep, traffic, wl, cfg, lines, feeder.fed, seed, log)
        log(f"[check] {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        log(f"error: modules loaded in this process: {', '.join(found)}")
        return 3, None
    res = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown:
        res["breakdown"] = breakdown
    res["checks"] = checks
    if t_build is not None:
        log(f"[setup] this run built the index ({t_build:.1f} s of "
            f"setup_s)")
    for k, c in checks.items():
        log(f"[check] {k} = {c['value']} (limit {c['limit']})")
    return 0, res


def _first_batch(wl, traffic):
    """The cell's first batch as the driver dispatches it (a pair batch
    fused: mate 1 lanes, then mate 2 lanes)."""
    B = int(wl.get("batch_size", 4096))
    ms = traffic.mates
    codes = np.concatenate([m.codes[:B] for m in ms])
    quals = np.concatenate([m.quals[:B] for m in ms])
    lens = np.concatenate([m.lens[:B] for m in ms])
    rd = np.arange(min(B, traffic.n), dtype=np.int64)
    return codes, quals, lens, np.concatenate([rd] * len(ms))


def _breakdown(d, w):
    ops = sorted(d["by_name"].items(), key=lambda x: -x[1])[:10]
    gaps = sorted(d["gaps"], reverse=True)[:10]
    idle = [[w.active_at((a + b) / 2) or "no span", g] for g, a, b in gaps]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": idle}


def main(argv=None, t_start=None):
    import argparse
    p = argparse.ArgumentParser(prog="h100_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    man = load_manifest()
    entry = cell_entry(man, a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        log(f"error: the cell {a.workload} needs {entry['chips']} CUDA "
            f"device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    rc, res = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                  t_start=t_start, manifest=man)
    if res is None:
        return rc or 1
    print(json.dumps(res), flush=True)
    return 0


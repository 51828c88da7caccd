"""Multi-host execution: read-shard assignment, per-host SAM shards, and
the deterministic ordered merge (copied from
hisat2_tpu/parallel/multihost.py; only init_distributed differs: it
brings up a torch.distributed process group in place of
jax.distributed).

The reference is a single-node pthreads program; its closest analogs are
the mutex-guarded read cursor (pat.h:163-241) and the ordered OutputQueue
flush (outq.h:37-149).  The TPU-native replacement follows SURVEY §2.6:

  - the index is replicated per host (each host loads it independently),
  - the READ STREAM is the parallel axis: host r processes batches i with
    i % world == r (block-cyclic; every host streams the same input and
    skips foreign batches, so no shared cursor and no coordinator is
    needed for the data path),
  - each host writes `<out>.shard<r>` plus a sidecar `.idx` recording the
    record count of each of its batches, then a `.done` sentinel with its
    summary counters,
  - rank 0 merges: batch 0 (host 0), batch 1 (host 1), ... — exactly the
    input order, independent of host completion times (OutputQueue
    semantics across hosts),
  - summary counters add across hosts (the reference's MERGE_METRICS).

torch.distributed is initialized only when a coordinator address is
given (NCCL for a run on the card, gloo on the CPU); the data path itself
needs no process group — there is no cross-host collective on the
alignment path.

Caveat (documented divergence): the temp splice-site DB is per-host, so
novel-junction reuse across host boundaries matches `-p N` thread
nondeterminism, not `-p 1`; use --known-splicesite-infile or a two-pass
--novel-splicesite-{out,in}file workflow for reproducible multi-host RNA
runs (the same advice the reference manual gives for -p N).
"""

from __future__ import annotations

import glob
import json
import os
import time


def init_distributed(coordinator: str, world: int, rank: int,
                     device: str = "cuda"):
    """torch.distributed bring-up: a process group of `world` ranks that
    meet at `coordinator` (host:port) over TCP, NCCL for a run on the card
    and gloo on the CPU."""
    import torch.distributed as dist
    backend = "nccl" if str(device).startswith("cuda") else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)


def shard_path(out: str, rank: int) -> str:
    return f"{out}.shard{rank}"


class ShardSamWriter:
    """Wraps a SamWriter-bound stream: records per-batch record counts so
    the merger can interleave batches deterministically."""

    def __init__(self, out: str, rank: int):
        self.path = shard_path(out, rank)
        self.f = open(self.path, "w")
        self.counts = []          # records per OWNED batch, in order
        self._cur = 0
        self._nlines = 0

    def write(self, s: str):
        self._nlines += s.count("\n")
        self.f.write(s)

    def end_batch(self):
        self.counts.append(self._nlines - self._cur)
        self._cur = self._nlines

    def finish(self, summary: dict):
        self.f.close()
        with open(self.path + ".idx", "w") as f:
            f.write("\n".join(map(str, self.counts)))
        with open(self.path + ".done", "w") as f:
            json.dump(summary, f)


def merge_shards(out: str, world: int, header: str = "",
                 timeout_s: float = 86400.0, poll_s: float = 0.5):
    """Rank-0 ordered merge: waits for every shard's .done sentinel, then
    interleaves batches block-cyclically into `out`.  Returns the summed
    summary counter dict."""
    paths = [shard_path(out, r) for r in range(world)]
    deadline = time.time() + timeout_s
    for p in paths:
        while not os.path.exists(p + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"shard sentinel missing: {p}.done")
            time.sleep(poll_s)
    counts = []
    for p in paths:
        with open(p + ".idx") as f:
            txt = f.read().strip()
        counts.append([int(x) for x in txt.split("\n")] if txt else [])
    summaries = []
    for p in paths:
        with open(p + ".done") as f:
            summaries.append(json.load(f))
    total = {}
    for s in summaries:
        for k, v in s.items():
            total[k] = total.get(k, 0) + v
    readers = [open(p) for p in paths]
    try:
        with open(out, "w") as fo:
            if header:
                fo.write(header)
            bi = [0] * world
            batch = 0
            n_batches = sum(len(c) for c in counts)
            while batch < n_batches:
                r = batch % world
                if bi[r] >= len(counts[r]):
                    batch += 1
                    continue
                for _ in range(counts[r][bi[r]]):
                    fo.write(readers[r].readline())
                bi[r] += 1
                batch += 1
    finally:
        for f in readers:
            f.close()
    return total


def cleanup_shards(out: str, world: int):
    for r in range(world):
        p = shard_path(out, r)
        for q in (p, p + ".idx", p + ".done"):
            if os.path.exists(q):
                os.remove(q)

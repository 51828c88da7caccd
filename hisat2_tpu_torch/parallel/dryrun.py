"""The multi-device dry run (twin of __graft_entry__.py:dryrun_multichip,
:56-116), one process per rank:

    python -m hisat2_tpu_torch.parallel.dryrun --world N --rank R \\
        --store PATH --device {cpu,cuda} [--parity OUT.npz]

Each rank joins a torch.distributed group through a FileStore at PATH
(gloo on the CPU, NCCL on the card; NCCL needs one card per rank), then

- runs the dp-sharded step (parallel/mesh.py) on a toy spliced aligner:
  an 8 kbp seeded genome, 8 reads of 64 bp per rank, the index
  replicated, the reads sharded, the valid-candidate count all-reduced;
  it must find at least 8 candidates per rank;
- runs the MPMD sharded-index path: a 24 kbp genome with an N at 8000
  built with a 12 kbp shard limit into two or more shards, placed on
  `shard_devices` (the CPU, or the host's cards in turn), 8 reads of
  60 bp aligned through align_batch, all 8 aligned;
- with --parity, also runs the step on tests/test_parallel.py's inputs
  (a seeded 20 kbp genome, 16 reads of 60 bp) and rank 0 writes the
  outputs in the global lane order (mesh.gather_lanes) and n_cand to
  OUT.npz.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..align.pipeline import TorchAligner
from ..index.builder import build_fm_index
from . import mesh


def _toy_setup(device, n_bp=20000, batch=64, read_len=80, seed=7):
    """Deterministic small index + simulated reads
    (__graft_entry__.py:_toy_setup)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n_bp).astype(np.uint8)
    index = build_fm_index([("toy", genome)])
    aligner = TorchAligner(index, spliced=True, device=device)
    starts = rng.integers(0, n_bp - read_len, batch)
    reads = np.stack([genome[s:s + read_len] for s in starts]).astype(
        np.int32)
    mask = rng.random((batch, read_len)) < 0.01
    reads = np.where(mask, (reads + 1) % 4, reads).astype(np.int32)
    quals = np.full((batch, read_len), 40, np.int32)
    lens = np.full(batch, read_len, np.int32)
    return aligner, reads, quals, lens


def run_step(aligner, group, device, reads, quals, lens, minsc):
    """The dp-sharded step on one batch: (this rank's outputs, n_cand)."""
    rdids = np.arange(reads.shape[0], dtype=np.int32)
    step = mesh.sharded_align_step(aligner, group)
    bundle = mesh.replicate(aligner, device)
    parts = mesh.shard_batch(group, reads, quals, lens, minsc, rdids)
    r, q, ln, ms, ri = (torch.from_numpy(np.ascontiguousarray(a)).to(
        device).to(torch.int32) for a in parts)
    return step(bundle, r, q, ln, ms, ri)


def dryrun_multichip(group, device) -> str:
    """The two checks of __graft_entry__.py:dryrun_multichip on this
    rank; returns a one-line summary."""
    world = dist.get_world_size(group)
    aligner, reads, quals, lens = _toy_setup(device, batch=8 * world,
                                             read_len=64, n_bp=8000)
    minsc = np.full(reads.shape[0], -20, np.int32)
    _, n_cand = run_step(aligner, group, device, reads, quals, lens, minsc)
    n_cand = int(n_cand)
    if n_cand < 8 * world:
        raise AssertionError(f"multichip dry run found only {n_cand} "
                             f"candidates")

    # sharded-index MPMD: a genome above the shard limit splits into
    # sub-indexes placed on different devices; each shard's pass runs where
    # its arrays live and the host merges candidates into global
    # coordinates
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 24000).astype(np.uint8)
    genome[8000] = 4                   # N split -> 2 fragments -> 2 shards
    sh_idx = build_fm_index([("toy2", genome)], shard_bp=12000)
    if len(sh_idx.shards) < 2:
        raise AssertionError("the 24 kbp genome did not split into shards")
    if device.type == "cuda":
        devs = [f"cuda:{i % torch.cuda.device_count()}"
                for i in range(len(sh_idx.shards))]
    else:
        devs = ["cpu"] * len(sh_idx.shards)
    al2 = TorchAligner(sh_idx, spliced=False, shard_devices=devs,
                       device=device)
    starts = np.concatenate([rng.integers(0, 7900, 4),
                             rng.integers(8100, 23900, 4)])
    reads2 = np.stack([genome[s:s + 60] for s in starts]).astype(np.uint8)
    res2 = al2.align_batch(reads2, np.full((8, 60), 40, np.uint8),
                           np.full(8, 60, np.int32))
    if res2.n_aligned != 8:
        raise AssertionError(f"sharded MPMD dry run aligned "
                             f"{res2.n_aligned}/8")
    return (f"dryrun rank {dist.get_rank(group)}/{world} on {device}: "
            f"n_cand {n_cand}; sharded-index MPMD over "
            f"{len(sh_idx.shards)} shards on {devs}: 8/8 aligned")


def parity(group, device, path):
    """The step on tests/test_parallel.py:23-86's inputs, gathered into
    the global lane order; rank 0 writes it and n_cand to `path`."""
    seq = np.random.default_rng(1234).integers(0, 4, 20000).astype(np.uint8)
    al = TorchAligner(build_fm_index([("chr_t", seq)]), spliced=True,
                      device=device)
    rng = np.random.default_rng(3)
    B, L = 16, 60
    starts = rng.integers(0, len(seq) - L, B)
    reads = np.stack([seq[s:s + L] for s in starts]).astype(np.int32)
    quals = np.full((B, L), 40, np.int32)
    lens = np.full(B, L, np.int32)
    minsc = np.full(B, -20, np.int32)
    out, n_cand = run_step(al, group, device, reads, quals, lens, minsc)
    glob = mesh.gather_lanes(out, group)
    if dist.get_rank(group) == 0:
        np.savez(path, n_cand=np.int64(n_cand), **glob)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "hisat2_tpu_torch.parallel.dryrun")
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--store", required=True,
                   help="the FileStore path the ranks meet at")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    p.add_argument("--parity", default=None, metavar="OUT.npz",
                   help="also run tests/test_parallel.py's inputs; rank 0 "
                   "writes the global outputs here")
    args = p.parse_args(argv)
    device = mesh.rank_device(args.device, args.rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(args.store, args.world)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, world_size=args.world,
                            rank=args.rank)
    try:
        print(dryrun_multichip(None, device), flush=True)
        if args.parity:
            parity(None, device, args.parity)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

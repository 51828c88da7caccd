"""Several devices on torch.distributed (counterpart of
hisat2_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a device mesh: the FM index
REPLICATED on every device, the read batch SHARDED over the 'dp' axis,
and the valid-candidate count summed with a psum (the reference's
MERGE_METRICS).  Here each rank is one process with one device in a
torch.distributed process group: `replicate` puts the aligner's device
bundle on the rank's device, `shard_batch` gives the rank its contiguous
row block of the batch (the batch must divide by the world size, as pjit
requires), and `sharded_align_step` runs the aligner's `_align_device` on
those rows and sums `(u_flags & 1)` across the group with
torch.distributed.all_reduce (K21).  K21 has no arithmetic of its own, so
it has no hand kernel: its body is the step, which runs through the
kernels of ops/, and the all-reduce is the collective library's (NCCL on
the card, gloo on the CPU), as the psum is XLA's.  `gather_lanes` rebuilds
the global lane order of the JAX program's dp-sharded outputs for checks.

`launches` counts the collective's calls (one per step), like a kernel
wrapper's launch count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

# the sharded steps run (each one all-reduce), reset by the caller
launches = 0


def rank_device(device: str, rank: int):
    """The device of `rank` on this host: cuda:<rank mod count> for
    'cuda', the CPU for 'cpu'."""
    if str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch finds no "
                               "CUDA device")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def shard_batch(group, *arrays):
    """This rank's contiguous row block of each host batch array (the
    leading axis sharded over the group, as P('dp'))."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    out = []
    for a in arrays:
        B = a.shape[0]
        if B % world:
            raise ValueError(f"a batch of {B} rows does not divide over "
                             f"{world} ranks")
        b = B // world
        out.append(a[rank * b:(rank + 1) * b])
    return tuple(out)


def replicate(aligner, device):
    """The aligner's device bundle on `device`: its (single-shard) index,
    graph tables and, for a site-injecting aligner, the site tables.
    Returns {"d", "gd", "ss"}."""
    dev = torch.device(device)
    d = aligner.dev
    if d.device != dev:
        d = dataclasses.replace(
            d, device=dev, **{f: getattr(d, f).to(dev) for f in
                              ("blocked", "fchr", "ftab2_top", "sa",
                               "ref_words")})
    gd = {k: v.to(dev) for k, v in aligner.shard_graph_dev[0].items()}
    ss = None
    if aligner.use_ss:
        ss = {k: v.to(dev) if torch.is_tensor(v) else v
              for k, v in aligner.splice_db.device_tables().items()}
    return {"d": d, "gd": gd, "ss": ss}


def sharded_align_step(aligner, group=None):
    """A step over the group (mesh.py:53): fn(bundle, reads, quals, lens,
    minsc, rdids) on this rank's rows (int32 tensors on the bundle's
    device) -> (this rank's output dict, the global valid-candidate
    count).  Like the JAX step it runs the full-output layout with
    uniform=False, so no per-batch choice makes a rank's lanes differ from
    the single-device step's."""
    def step(bundle, reads, quals, lens, minsc, rdids=None):
        global launches
        out, _ = aligner._align_device(
            bundle["d"], bundle["gd"], reads, quals, lens, minsc, False,
            True, rdids=rdids, ss=bundle["ss"])
        # valid = bit 0 of the flags (pipeline.py's D2H shrink)
        n_cand = (out["u_flags"] & 1).sum().to(torch.int64).reshape(1)
        dist.all_reduce(n_cand, op=dist.ReduceOp.SUM, group=group)
        launches += 1
        return out, n_cand[0]
    return step


def gather_lanes(out: dict, group=None) -> dict:
    """The global lane order of the JAX program's dp-sharded outputs from
    every rank's output dict (numpy, on every rank).  A rank's 2b lanes
    are [fw of its b reads; rc of its b reads]; the global array is [fw of
    all B reads; rc of all B reads], so the fw halves of the ranks come
    first, then their rc halves (a plain all_gather + cat would
    interleave them)."""
    world = dist.get_world_size(group)
    res = {}
    for k in sorted(out):
        v = out[k]
        is_bool = v.dtype == torch.bool
        t = (v.to(torch.uint8) if is_bool else v).contiguous()
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        parts = [p.cpu().numpy() for p in parts]
        if is_bool:
            parts = [p.astype(bool) for p in parts]
        b = parts[0].shape[0] // 2
        res[k] = np.concatenate([p[:b] for p in parts]
                                + [p[b:] for p in parts])
    return res

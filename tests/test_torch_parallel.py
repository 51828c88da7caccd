"""Several devices on the port (hisat2_tpu_torch/parallel), on the CPU:

- the dp-sharded step (K21: the step on this rank's rows, the
  valid-candidate count all-reduced) at world 2, as two fresh `python -m
  hisat2_tpu_torch.parallel.dryrun` processes on gloo meeting at a
  FileStore, on tests/test_parallel.py:23-86's inputs, held against
  hisat2_tpu.parallel.mesh.sharded_align_step on the 8-device virtual
  mesh of tests/conftest.py with that test's comparison: per-lane
  valid-slot sets, per-lane fields exact, n_cand equal (the port's outputs
  in the JAX program's global lane order, mesh.gather_lanes);
- the dry-run twin of __graft_entry__.py:dryrun_multichip at world 2 (the
  same two processes);
- world 1 in-process (gloo, HashStore): the sharded step equals the plain
  step exactly;
- a two-shard index with shard_devices=["cpu", "cpu"] equals the default
  placement.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.index import build_fm_index as t_build_fm_index
from hisat2_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Two dry-run ranks on gloo; rank 0 writes the parity outputs."""
    d = tmp_path_factory.mktemp("dp2")
    store, out = str(d / "store"), str(d / "parity.npz")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hisat2_tpu_torch.parallel.dryrun",
         "--world", "2", "--rank", str(r), "--store", store, "--device",
         "cpu", "--parity", out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    logs = []
    for p in procs:
        o, e = p.communicate(timeout=600)
        logs.append((p.returncode, o, e))
    return logs, out


def test_dryrun_twin_world2(world2):
    logs, _ = world2
    for r, (rc, o, e) in enumerate(logs):
        assert rc == 0, e[-3000:]
        assert f"dryrun rank {r}/2 on cpu" in o
        assert "8/8 aligned" in o
        n = int(o.split("n_cand ")[1].split(";")[0])
        assert n >= 16


def test_sharded_step_world2_matches_jax(world2, small_index):
    """tests/test_parallel.py:test_sharded_matches_single_device with the
    port's world-2 step in place of the single-device one."""
    import jax

    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.parallel import mesh as pmesh
    logs, path = world2
    assert all(rc == 0 for rc, _, _ in logs), logs[0][2][-3000:]
    got = dict(np.load(path))
    n_port = int(got.pop("n_cand"))

    idx, seq = small_index
    al = TPUAligner(idx, spliced=True)
    rng = np.random.default_rng(3)
    B, L = 16, 60
    starts = rng.integers(0, len(seq) - L, B)
    reads = np.stack([seq[s:s + L] for s in starts]).astype(np.int32)
    quals = np.full((B, L), 40, np.int32)
    lens = np.full(B, L, np.int32)
    minsc = np.full(B, -20, np.int32)
    rdids = np.arange(B, dtype=np.int32)
    ss = al.splice_db.device_tables()
    m = pmesh.make_mesh(n_dp=8)
    step = pmesh.sharded_align_step(al, m)
    d = pmesh.replicate(m, al.dev)
    params = pmesh.replicate(m, al.params)
    ss_r = pmesh.replicate(m, ss)
    r, q, ln, ms, ri = pmesh.shard_batch(m, reads, quals, lens, minsc,
                                         rdids)
    want, n_cand = step(d, params, r, q, ln, ms, ri, ss_r)
    jax.block_until_ready(n_cand)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(want) == sorted(got)
    # per-lane valid-slot sets over the slot fields, per-lane fields exact
    sv = want["u_flags"] & 1
    hv = got["u_flags"] & 1
    np.testing.assert_array_equal(sv.sum(axis=1), hv.sum(axis=1),
                                  err_msg="valid-count")
    slot_keys = [k for k in want
                 if k.startswith("u_") and want[k].ndim == 2
                 and want[k].shape[1] == sv.shape[1] and k != "u_alt"]
    for lane in range(sv.shape[0]):
        a = {tuple(int(want[k][lane, j]) for k in slot_keys)
             for j in np.flatnonzero(sv[lane])}
        b = {tuple(int(got[k][lane, j]) for k in slot_keys)
             for j in np.flatnonzero(hv[lane])}
        assert a == b, f"lane {lane} valid-slot sets differ"
    for k in want:
        if k in slot_keys or k == "u_alt" or k.startswith("sp_"):
            continue
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      want[k].astype(np.int64), err_msg=k)
    assert n_port == int(np.asarray(n_cand)) == int(sv.sum())
    assert n_port >= B


def test_world1_step_equals_plain_step():
    """World 1 on gloo in this process: the sharded step's outputs are the
    plain step's, and n_cand their valid-slot count."""
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 12000).astype(np.uint8)
    al = TorchAligner(t_build_fm_index([("c", g)]), spliced=True,
                      device="cpu")
    B, L = 8, 64
    starts = rng.integers(0, len(g) - L, B)
    reads = np.stack([g[s:s + L] for s in starts]).astype(np.int32)
    quals = np.full((B, L), 40, np.int32)
    lens = np.full(B, L, np.int32)
    minsc = np.full(B, -20, np.int32)
    rdids = np.arange(B, dtype=np.int32)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        np.testing.assert_array_equal(mesh.shard_batch(None, reads)[0],
                                      reads)
        n0 = mesh.launches
        bundle = mesh.replicate(al, "cpu")
        t = [torch.from_numpy(a) for a in (reads, quals, lens, minsc,
                                           rdids)]
        out, n_cand = mesh.sharded_align_step(al, None)(bundle, *t)
        assert mesh.launches == n0 + 1
        glob = mesh.gather_lanes(out, None)
        ss = al.splice_db.device_tables()
        plain, _ = al._align_device(al.dev, al.shard_graph_dev[0], *t[:4],
                                    False, True, rdids=t[4], ss=ss)
        assert sorted(plain) == sorted(out) == sorted(glob)
        for k in plain:
            assert torch.equal(out[k], plain[k]), k
            np.testing.assert_array_equal(glob[k], plain[k].numpy(),
                                          err_msg=k)
        assert int(n_cand) == int((plain["u_flags"] & 1).sum()) >= B
    finally:
        dist.destroy_process_group()


def _shard_rows(a, world, rank):
    """shard_batch at a world size no test process has (the group's size
    and rank mocked)."""
    import unittest.mock as um
    with um.patch.object(dist, "get_world_size", return_value=world), \
            um.patch.object(dist, "get_rank", return_value=rank):
        return mesh.shard_batch(None, a)


def test_shard_batch_rows_of_a_rank():
    a = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(_shard_rows(a, 4, 1)[0], a[2:4])
    np.testing.assert_array_equal(_shard_rows(a, 4, 3)[0], a[6:8])
    with pytest.raises(ValueError, match="does not divide"):
        _shard_rows(a[:6], 4, 0)


def test_shard_devices_cpu_cpu_equals_default():
    """A two-shard index with each shard placed on "cpu" by shard_devices
    aligns as with the default placement (every shard on the aligner's
    device)."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, 24000).astype(np.uint8)
    genome[8000] = 4
    idx = t_build_fm_index([("toy2", genome)], shard_bp=12000)
    assert len(idx.shards) >= 2
    a1 = TorchAligner(idx, device="cpu")
    a2 = TorchAligner(idx, device="cpu",
                      shard_devices=["cpu"] * len(idx.shards))
    starts = np.concatenate([rng.integers(0, 7900, 6),
                             rng.integers(8100, 23900, 6)])
    codes = np.stack([genome[s:s + 60] for s in starts]).astype(np.uint8)
    codes[3, 20] = (codes[3, 20] + 1) % 4
    quals = np.full(codes.shape, 40, np.uint8)
    lens = np.full(len(codes), 60, np.int32)
    r1, r2 = a1.align_batch(codes, quals, lens), a2.align_batch(codes, quals,
                                                                lens)
    for c1, c2 in zip(r1.raw["cols"], r2.raw["cols"]):
        np.testing.assert_array_equal(c1, c2)
    assert r2.n_aligned == len(codes)


def test_kernel_launch_selects_the_stream_device(monkeypatch):
    """Kernel.launch calls the C entry point with the stream's device
    current (torch.cuda.device around the call) and counts only a launch
    that returned 0; the library and torch.cuda.device are mocked, so this
    runs without a card."""
    import types

    from hisat2_tpu_torch import kernels
    log = []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            log.append(("enter", str(self.d)))

        def __exit__(self, *a):
            log.append(("exit", str(self.d)))

    def entry(*args):
        log.append(("call", args[-1]))
        return args[0]

    lib = types.SimpleNamespace(h2_pair_sweep=entry,
                                h2_error_string=lambda e: b"refused")
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", Device)
    k = kernels.KERNELS["pair_sweep"]
    n0 = k.launches
    stream = types.SimpleNamespace(device=torch.device("cuda", 1),
                                   cuda_stream=4242)
    k.launch(0, 7, stream=stream)
    assert log == [("enter", "cuda:1"), ("call", 4242), ("exit", "cuda:1")]
    assert k.launches == n0 + 1
    log.clear()
    with pytest.raises(RuntimeError, match="refused"):
        k.launch(9, stream=stream)
    assert log == [("enter", "cuda:1"), ("call", 4242), ("exit", "cuda:1")]
    assert k.launches == n0 + 1

"""Port parity for the whole slice: the torch aligner's device step, host
phase and CLI against hisat2_tpu on the CPU.

- the packed step buffer, its layout (_out_specs) and every unpacked key
  equal TPUAligner's, for uniform and variable lengths, in the spill and
  full_out layouts, with and without the lane metadata the CLI ships;
- a multimap-saturated batch overflows the spill rows and re-runs
  full_out, as in the JAX package;
- align_batch's raw columns equal TPUAligner.align_batch's;
- `python -m hisat2_tpu_torch align --device cpu` writes the committed
  oracle SAM bodies byte for byte in the four reporting modes of
  tests/test_reporting_modes.py, in a process where neither jax nor
  hisat2_tpu can import;
- the port never imports jax or hisat2_tpu, runs paired reads on linear
  and graph indexes, and refuses the modes it does not run.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import SpillOverflow as JSpillOverflow
from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu_torch.align.host import SpillOverflow
from hisat2_tpu_torch.align.pipeline import TorchAligner

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# makes `import jax` fail, as on a machine without JAX, and `import
# hisat2_tpu` too: the port keeps its own copies of what it needs
NO_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hisat2_tpu"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""


def _batch(seq, B, L, seed, var_lens):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(seq) - L, B)
    codes = np.stack([seq[s:s + L] for s in starts]).astype(np.uint8)
    for i in range(0, B, 3):
        codes[i, rng.integers(5, L - 5)] = (codes[i, 10] + 1) % 4
    codes[::7, L - 10:] = rng.integers(0, 4, (len(codes[::7]), 10))
    codes[1::5] = np.where(codes[1::5] < 4, 3 - codes[1::5], 4)[:, ::-1]
    codes[2, L // 2] = 4
    # a 3 bp deletion and a 2 bp insertion (indel sweep rows)
    s = int(starts[4])
    codes[4] = np.concatenate([seq[s:s + 30], seq[s + 33:s + L + 3]])
    s = int(starts[5])
    codes[5] = np.concatenate([seq[s:s + 40], [1, 2], seq[s + 40:s + L - 2]])
    quals = rng.integers(2, 41, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    if var_lens:
        lens[::4] = L - rng.integers(1, 20, len(lens[::4]))
        for i in range(0, B, 4):
            codes[i, lens[i]:] = 4
    return codes, quals, lens


@pytest.fixture(scope="module")
def aligners(small_index):
    idx, seq = small_index
    return seq, {lm: (TPUAligner(idx, lane_meta=lm),
                      TorchAligner(idx, lane_meta=lm, device="cpu"))
                 for lm in (False, True)}


@pytest.mark.parametrize("var_lens,full_out,lane_meta", [
    (False, False, False), (False, True, True),
    (True, False, True), (True, True, False)])
def test_step_matches_jax(aligners, var_lens, full_out, lane_meta):
    seq, al = aligners
    ja, ta = al[lane_meta]
    codes, quals, lens = _batch(seq, 48, 80, 7 + var_lens, var_lens)
    B = len(lens)
    minsc = np.array([ja.scoring.min_score(int(x)) for x in lens], np.int64)
    uniform = not var_lens
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jp = ja._dispatch_packed(rd, qd, np.arange(B), uniform, h2d,
                             full_out=full_out)[0]
    tp = ta._dispatch_packed(codes, quals, lens, minsc, uniform,
                             full_out=full_out)[0]
    w = np.asarray(jp).shape[1]
    assert ja._out_specs[w] == ta._out_specs[w]
    assert ja._spill_meta[w] == ta._spill_meta[w]
    np.testing.assert_array_equal(np.asarray(jp), tp[0].numpy())
    jo, to = ja._fetch_out(jp), ta._fetch_out(tp)
    assert sorted(jo) == sorted(to)
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k], err_msg=k)
    # the batch exercised the indel sweep and the extra slots
    assert (jo["u_dd"] != 0).any()


def test_align_batch_matches_jax(aligners):
    seq, al = aligners
    ja, ta = al[False]
    codes, quals, lens = _batch(seq, 48, 80, 11, True)
    ra, rb = ja.align_batch(codes, quals, lens), ta.align_batch(codes, quals,
                                                                lens)
    assert rb.n_aligned == ra.n_aligned > 40
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_spill_overflow_matches_jax():
    """9 copies of a unit: every read fills 9 valid slots, more than the
    S = 2B spill rows hold, so both aligners re-run full_out."""
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    parts = []
    for _ in range(9):
        parts += [unit, rng.integers(0, 4, 200).astype(np.uint8)]
    idx = build_fm_index([("chr_r", np.concatenate(parts))])
    ja, ta = TPUAligner(idx), TorchAligner(idx, device="cpu")
    B, L = 24, 80
    offs = rng.integers(0, 400, B)
    codes = np.stack([unit[o:o + L] for o in offs]).astype(np.uint8)
    quals = np.full((B, L), 40, np.uint8)
    lens = np.full(B, L, np.int32)
    minsc = np.array([ta.scoring.min_score(L)] * B, np.int64)
    with pytest.raises(SpillOverflow):
        ta._fetch_out(ta._dispatch_packed(codes, quals, lens, minsc,
                                          True)[0])
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    with pytest.raises(JSpillOverflow):
        ja._fetch_out(ja._dispatch_packed(rd, qd, np.arange(B), True,
                                          h2d)[0])
    ra, rb = ja.align_batch(codes, quals, lens), ta.align_batch(codes, quals,
                                                                lens)
    assert rb.n_aligned == B
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _run_port(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    code = (NO_JAX + "import runpy\n"
            "sys.argv = ['hisat2_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('hisat2_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n"
            "    assert 'hisat2_tpu' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code] + args, cwd=cwd,
                       env=env, capture_output=True, text=True, timeout=600)
    return r


@pytest.fixture(scope="module")
def mm3_idx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm3t")
    with gzip.open(f"{DATA}/mm3_genome.fa.gz", "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    r = _run_port(["build", "g.fa", "idx"], str(d))
    assert r.returncode == 0, r.stderr[-2000:]
    return d


@pytest.mark.parametrize("name,extra", [
    ("k10", ["-k", "10"]),
    ("sec", ["-k", "3", "--secondary"]),
    ("a", ["-a"]),
    ("ms", ["-k", "2", "--max-seeds", "30"]),
])
def test_cli_matches_oracle(mm3_idx, name, extra):
    out = str(mm3_idx / f"torch_{name}.sam")
    r = _run_port(["align", "--no-spliced-alignment", "-f", "-x", "idx",
                   "-U", f"{DATA}/mm3_reads.fa", "-S", out,
                   "--device", "cpu"] + extra, str(mm3_idx))
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as f:
        got = [x for x in f if not x.startswith("@")]
    with gzip.open(f"{DATA}/mm3_ref_{name}.sam.gz", "rt") as f:
        want = [x for x in f if not x.startswith("@")]
    assert got == want


def test_port_never_imports_jax():
    """Import the port, run one CPU batch with the hybrid replay and load
    the CLI's import path, in a process where neither jax nor hisat2_tpu
    can import."""
    code = NO_JAX + """
import numpy as np
from hisat2_tpu_torch.index import build_fm_index
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.align import hybrid
import hisat2_tpu_torch.__main__, hisat2_tpu_torch.cli.align
import hisat2_tpu_torch.align.driver
from hisat2_tpu_torch import kernels
rng = np.random.default_rng(3)
seq = rng.integers(0, 4, 20000).astype(np.uint8)
al = TorchAligner(build_fm_index([("c", seq)]), lane_meta=True,
                  device="cpu")
codes = np.stack([seq[s:s + 60] for s in (10, 500, 9000)])
codes[1, 50:] = 0
q = np.full(codes.shape, 30, np.uint8)
lens = np.full(3, 60, np.int32)
res = al.align_batch(codes, q, lens)
hybrid.substitute_batch(al, res, codes, q, lens, np.arange(3))
hisat2_tpu_torch.cli.align.build_parser().parse_args(["-x", "i", "-U", "r"])
assert res.n_aligned == 3
assert sum(kernels.counts().values()) == 0
assert "jax" not in sys.modules and "hisat2_tpu" not in sys.modules
print("NO_JAX_OK")
"""
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO_JAX_OK" in r.stdout, r.stderr[-2000:]


def test_dna_replay_never_reaches_probscore(aligners, monkeypatch):
    """The port's HybridAligner.probscore (the PWM model of spliced
    replays) is never reached by the DNA-mode replay, even when every
    read is replayed."""
    from hisat2_tpu_torch.align import hybrid

    def boom(*a, **k):
        raise AssertionError("probscore reached in DNA mode")

    monkeypatch.setattr(hybrid.HybridAligner, "probscore", boom)
    seq, al = aligners
    ta = al[True][1]
    codes, quals, lens = _batch(seq, 24, 80, 3, False)
    res = ta.align_batch(codes, quals, lens)
    over = hybrid.substitute_batch(ta, res, codes, quals, lens,
                                   np.arange(24), exact=True)
    assert over


@pytest.mark.parametrize("extra,why", [
    # paired reads run, on a linear and on a graph index (why None)
    (["-1", "M1", "-2", "M2", "--no-spliced-alignment"], None),
    # spliced runs, unpaired (tests/test_torch_spliced_cli.py) and paired
    # (the default for -1/-2; tests/test_torch_paired_spliced.py)
    (["-1", "M1", "-2", "M2"], None),
    # multi-host runs (tests/test_torch_multihost.py runs both ranks):
    # rank 1 of 2 aligns the batches it owns into its SAM shard
    (["-U", "M1", "--no-spliced-alignment", "--n-hosts", "2", "--host-rank",
      "1", "--batch-size", "4"], None),
    (["-1", "M1", "-2", "M2", "--no-spliced-alignment", "VAR"], None),
])
def test_cli_refuses_unported_modes(tmp_path, capsys, extra, why):
    from hisat2_tpu_torch.cli.align import main
    from hisat2_tpu_torch.index import attach_variants
    base = str(tmp_path / "idx")
    if why is None:
        rng = np.random.default_rng(4)
        g = rng.integers(0, 4, 30000).astype(np.uint8)
        idx = build_fm_index([("c", g)])
        if "VAR" in extra:
            snp = tmp_path / "v.snp"
            snp.write_text("".join(f"v{p}\tsingle\tc\t{p}\t"
                                   f"{'ACGT'[(int(g[p]) + 1) % 4]}\n"
                                   for p in range(500, 29500, 700)))
            attach_variants(idx, snp_file=str(snp))
            idx._variants.save(base)
        idx.save(base)
        starts = rng.integers(0, 29000, 12)
        rc = lambda s: "".join("TGCA"[c] for c in s[::-1])  # noqa: E731
        for m, off in (("M1", 0), ("M2", 300)):
            (tmp_path / m).write_text("".join(
                f">p{i}\n" + ("".join("ACGT"[c] for c in g[s:s + 80])
                              if m == "M1" else rc(g[s + 220:s + 300]))
                + "\n" for i, s in enumerate(starts)))
        extra = [str(tmp_path / x) if x in ("M1", "M2") else x
                 for x in extra if x != "VAR"]
        out = str(tmp_path / "pe.sam")
        assert main(["-x", base, "--device", "cpu", "-f", "-S", out,
                     "--quiet"] + extra) == 0
        if "--n-hosts" in extra:
            # rank 1 owns batch 1 of the three 4-read batches
            with open(out + ".shard1") as f:
                recs = [x.split("\t") for x in f]
            with open(out + ".shard1.idx") as f:
                assert f.read() == "4"
            assert os.path.exists(out + ".shard1.done")
            assert [r[0] for r in recs] == ["p4", "p5", "p6", "p7"]
            assert all(int(r[1]) & 4 == 0 for r in recs)
            assert not os.path.exists(out)
            return
        with open(out) as f:
            flags = [int(x.split("\t")[1]) for x in f
                     if not x.startswith("@")]
        assert len(flags) == 24 and all(f & 2 for f in flags)
        return
    if "VAR" in extra:
        extra = [x for x in extra if x != "VAR"]
        open(base + ".var.npz", "wb").close()
    assert main(["-x", base, "--device", "cpu"] + extra) == 1
    assert why in capsys.readouterr().err


def test_cuda_device_without_gpu_raises(small_index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchAligner(small_index[0], device="cuda")

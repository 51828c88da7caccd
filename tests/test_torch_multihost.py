"""Multi-host runs of the port's CLI on the CPU (tests/test_multihost.py on
hisat2_tpu_torch): two `align --n-hosts 2 --host-rank r` processes each
own the batches i with i % 2 == r and write a SAM shard with its batch
record counts, and rank 0 merges the shards in input order
(parallel/multihost.py).  The merged body must equal the single-host port
run and the committed oracle (mm3_ref_k10, written by hisat2_tpu), with
and without --coordinator (a gloo process group over TCP on localhost).
The mm3 corpus's 40 reads go in batches of 8: five batches, three on rank
0 and two on rank 1."""

import gzip
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "hisat2_tpu_torch"]
                            + args, cwd=cwd, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _wait(p, timeout=600):
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]


def _body(path, opener=open):
    with opener(path, "rt") as f:
        return [x for x in f if not x.startswith("@")]


@pytest.fixture(scope="module")
def mm3(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm3mh")
    with gzip.open(f"{DATA}/mm3_genome.fa.gz", "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    _wait(_cli(["build", "g.fa", "idx"], str(d)))
    return d


BASE = ["align", "--no-spliced-alignment", "-f", "-x", "idx", "-U",
        f"{DATA}/mm3_reads.fa", "-k", "10", "--batch-size", "8",
        "--device", "cpu"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("coordinator", (False, True))
def test_two_process_merge(mm3, coordinator):
    d = str(mm3)
    tag = "c" if coordinator else "f"
    if not os.path.exists(os.path.join(d, "single.sam")):
        _wait(_cli(BASE + ["-S", "single.sam"], d))
    extra = (["--coordinator", f"127.0.0.1:{_free_port()}"]
             if coordinator else [])
    procs = [_cli(BASE + extra + ["--n-hosts", "2", "--host-rank", str(r),
                                  "-S", f"multi_{tag}.sam"], d)
             for r in (1, 0)]
    for p in procs:
        _wait(p)
    multi = _body(os.path.join(d, f"multi_{tag}.sam"))
    assert multi == _body(os.path.join(d, "single.sam"))
    assert multi == _body(f"{DATA}/mm3_ref_k10.sam.gz", gzip.open)
    with open(os.path.join(d, f"multi_{tag}.sam")) as f:
        assert f.readline().startswith("@HD")
    left = [x for x in os.listdir(d) if ".shard" in x]
    assert not left, left

"""The junction sweeps K13 (pair_sweep) and K15 (second_sweep) and the
indel sweep K8 (indel_sweep) of this tree against an earlier commit's, in
turns on one card.

    git archive <commit> hisat2_tpu_torch/csrc | tar -x -C DIR
    python3 sweep_ab.py DIR

(DIR in a directory .gitignore lists, e.g. .chipwork/parent.)  It builds
the earlier commit's pair_sweep.cu and second_sweep.cu into libraries of
their own (their C symbols are this tree's), each whole and stopped right
after its plane prologue (the sp_build call), this tree's stopped the
same way, and the earlier indel_sweep.cu whole: one nvcc per library, all
started together.  Then it runs chip_smoke.py's phases.  On phase 10's
and phase 11 (e)'s spliced full step (where chip_smoke.launch_shape is
called for K13, then K15), and for K8 on phase 4's linear step and phase
11 (e)'s config-6 full step (the first and the last step where
launch_shape is called for K8), it takes the step's captured arguments
and

- checks that the earlier kernels give this tree's outputs;
- times each kernel (K13 and K15 whole and prologue-only, K8 whole), 20
  launches back to back between two CUDA events (median of 5 rounds), in
  turns: earlier, this, this, earlier.  K13's and K15's launches are
  issued from the host; K8's are captured in one CUDA graph (device
  time), since the wrapper's host work per call outlasts the new kernel.

Both trees launch through this tree's wrappers (ops/splice.py); only the C
entry point differs, so the arguments and the host work per launch are
the same.  The earlier K15 must take both base pairs of a step in one
launch, as this tree's does.  Prints one
`[sweep ab] <step> {json}` line per step for K13 + K15 and one
`[sweep ab] <step> indel_sweep {json}` line per step for K8, then
chip_smoke's own lines.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import chip_smoke

SWEEPS = ("pair_sweep", "second_sweep")
# what a prologue-only copy writes, so that its planes stay live
PRO_SINK = {"pair_sweep": "A.bsel[(size_t)n * 2]", "second_sweep": "A.out[n]"}


def sweep_source(src, name, pro):
    """pair_sweep.cu / second_sweep.cu, stopped after sp_build if pro."""
    text = open(os.path.join(src, name + ".cu")).read()
    if pro:
        at = text.index("sp_build(", text.index("__global__"))
        end = text.index(");", at) + 2
        text = (text[:end] + "\n  __syncthreads();\n  if (threadIdx.x == 0) "
                f"{PRO_SINK[name]} = s.P[L] + (int)s.Pm[L];\n  return;"
                + text[end:])
    return text


def build_libs(kernels, parent_csrc):
    """{(tree, name, pro): the library's C entry point}."""
    out = os.path.join(kernels.BUILD_DIR, "sweep_ab")
    os.makedirs(out, exist_ok=True)
    jobs = []
    todo = [("parent", parent_csrc, name, pro) for name in SWEEPS
            for pro in (False, True)]
    todo += [("this", kernels.CSRC, name, True) for name in SWEEPS]
    todo.append(("parent", parent_csrc, "indel_sweep", False))
    for tree, src, name, pro in todo:
        tag = f"{tree}_{name}_{'pro' if pro else 'whole'}"
        cu = os.path.join(out, tag + ".cu")
        with open(cu, "w") as f:
            f.write(sweep_source(src, name, pro))
        so = os.path.join(out, f"lib{tag}.so")
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-I", src, "-o", so, cu]
        jobs.append(((tree, name, pro), so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    fns = {}
    for key, so, p in jobs:
        _, err = p.communicate()
        chip_smoke.check(p.returncode == 0, f"nvcc {key}: {err[-3000:]}")
        fn = getattr(ctypes.CDLL(so), "h2_" + key[1])
        fn.argtypes = kernels.KERNELS[key[1]].argtypes
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def through(torch, kernels, name, fn, call):
    """call() with the wrapper of kernel `name` launching the C function
    fn in place of this tree's."""
    if fn is None:
        return call()
    k = kernels.KERNELS[name]

    def launch(*args, stream):
        with torch.cuda.device(stream.device):
            err = fn(*args, stream.cuda_stream)
        chip_smoke.check(err == 0, f"{name}: launch error {err}")
    k.launch = launch
    try:
        return call()
    finally:
        del k.launch


def b2b_ms(torch, fn, reps=20, rounds=5):
    """Per-launch time of fn, `reps` calls back to back between two CUDA
    events, median of `rounds`."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(torch, fn, reps=20, rounds=5):
    """Per-launch device time of fn: `reps` calls captured in one CUDA
    graph, replayed between two CUDA events, median of `rounds`.  The
    host's work per call (the wrapper's checks and allocations) is left
    out, where b2b_ms waits on it once a launch is shorter."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def same(torch, a, b):
    """Equal tensors, f32 by their bits."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def compare_step(torch, kernels, splice, fns, tag, k13, k15):
    """Equal outputs, then the timings in turns; prints and returns them."""
    def k13_fn(tree, pro):
        fn = None if (tree, pro) == ("this", False) else fns[
            (tree, "pair_sweep", pro)]
        return lambda: through(torch, kernels, "pair_sweep", fn,
                               lambda: splice.pair_sweep(**k13))

    def k15_fn(tree, pro):
        fn = None if (tree, pro) == ("this", False) else fns[
            (tree, "second_sweep", pro)]
        return lambda: through(torch, kernels, "second_sweep", fn,
                               lambda: splice.second_sweep(**k15))

    new, old = k13_fn("this", False)(), k13_fn("parent", False)()
    for part in (0, 1):
        for f in new[part]:
            chip_smoke.check(same(torch, new[part][f], old[part][f]),
                             f"{tag}: pair_sweep part {part} {f} != parent")
    chip_smoke.check(torch.equal(new[2], old[2]),
                     f"{tag}: base pairs != parent")
    new, old = k15_fn("this", False)(), k15_fn("parent", False)()
    for t in (0, 1):
        for side in ("right", "left"):
            for f, v in new[t][side].items():
                chip_smoke.check(same(torch, v, old[t][side][f]),
                                 f"{tag}: second_sweep pair {t} {side} {f} "
                                 f"!= parent")
    res = {}
    for name, mk in (("pair_sweep", k13_fn), ("second_sweep", k15_fn)):
        for pro in (False, True):
            f = {tr: mk(tr, pro) for tr in ("parent", "this")}
            t = [b2b_ms(torch, f[tr])
                 for tr in ("parent", "this", "this", "parent")]
            res[f"{name}_{'prologue' if pro else 'whole'}"] = {
                "parent": [t[0], t[3]], "this": [t[1], t[2]]}
    st, vd, prm = k13["starts"], k13["valid"], k13["prm"]
    gcap = k13["max_gap"] or prm.max_gap
    D = st[:, None, :] - st[:, :, None]
    spl = (D >= prm.min_intron) & (D <= prm.max_intron)
    join = spl | ((D >= 1) & (D < prm.min_intron)) | ((D <= -1)
                                                       & (D >= -gcap))
    both = vd[:, :, None] & vd[:, None, :] & join
    res["pair_kinds"] = {k: float(v.float().mean()) for k, v in (
        ("splice", spl & both), ("indel", ~spl & both),
        ("splice_invalid", spl & ~both), ("rest", ~spl & ~both))}
    res["N"], res["C"], res["L"] = (st.shape[0], st.shape[1],
                                    k13["reads"].shape[1])
    print(f"[sweep ab] {tag}: {json.dumps(res)}", flush=True)
    return res


def compare_k8(torch, kernels, splice, fns, tag, kw):
    """K8 of both trees on one step's arguments: equal outputs, then the
    whole kernel's timings in turns; prints and returns them."""
    fn = {"parent": fns[("parent", "indel_sweep", False)], "this": None}
    run = {tr: (lambda f=f: through(torch, kernels, "indel_sweep", f,
                                    lambda: splice.self_indel_sweep(**kw)))
           for tr, f in fn.items()}
    new, old = run["this"](), run["parent"]()
    for f in new:
        chip_smoke.check(torch.equal(new[f], old[f]),
                         f"{tag}: indel_sweep {f} != parent")
    t = [graph_ms(torch, run[tr]) for tr in ("parent", "this", "this",
                                             "parent")]
    N, C, W = kw["ch"].shape
    L = kw["reads"].shape[1]
    res = {"indel_sweep_whole": {"parent": [t[0], t[3]],
                                 "this": [t[1], t[2]]},
           "live_share": float(kw["valid"].float().mean()), "N": N, "C": C,
           "W": W, "L": L,
           "G": splice.indel_sweep_gap(L, W, kw["max_gap"], kw["prm"]),
           "snv": kw.get("snv1_w") is not None}
    print(f"[sweep ab] {tag} indel_sweep: {json.dumps(res)}", flush=True)
    return res


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("sweep_ab.py: no CUDA device", file=sys.stderr)
        return 1
    from hisat2_tpu_torch import kernels
    from hisat2_tpu_torch.ops import splice
    kernels.load()
    fns = build_libs(kernels, os.path.join(os.path.abspath(sys.argv[1]),
                                           "hisat2_tpu_torch", "csrc"))
    caps, done, k8 = {}, [], []
    n_k8 = [0]
    shape = chip_smoke.launch_shape

    def hook(splice_mod, name, kw):
        caps[name] = kw
        if name == "second_sweep":
            tag = ("phase10", "config6")[len(done)]
            done.append(compare_step(torch, kernels, splice, fns, tag,
                                     caps["pair_sweep"], kw))
        if name == "indel_sweep":
            # phase 4's linear step comes first; config 6's full step
            # follows its own K13 + K15 comparison
            if n_k8[0] == 0 or len(done) == 2:
                tag = "linear" if n_k8[0] == 0 else "config6"
                k8.append(compare_k8(torch, kernels, splice, fns, tag, kw))
            n_k8[0] += 1
        return shape(splice_mod, name, kw)
    chip_smoke.launch_shape = hook
    rc = chip_smoke.main()
    chip_smoke.check(len(done) == 2, f"{len(done)} of 2 steps compared")
    chip_smoke.check(len(k8) == 2, f"K8 compared on {len(k8)} of 2 steps")
    return rc


if __name__ == "__main__":
    sys.exit(main())

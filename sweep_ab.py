"""The hand kernels this port has redesigned, against an earlier
commit's, in turns on one card: the junction sweeps K13 (pair_sweep) and
K15 (second_sweep), the indel sweep K8 (indel_sweep), the ungapped
extension K6+K7 (extend_ungapped), the FM search K1 (fm_search2, and
its lane-list mode K17), the candidate compaction K3+K4 (compact_cands),
the slot merge K9 (pack_slots, as a region with the schema glue it
absorbed), the splice-site injection K16 (inject_known), the sampled-SA
walk K19+K20 (resolve_walk), the known-indel injection K10+K11
(inject_indels), the reference windows K5 (ref_window, as a region:
a step's windows), the mate-rescue window K12 (rescue_window) and the
site merge K18 (merge_sites).

    git archive <commit> hisat2_tpu_torch/csrc | tar -x -C DIR
    python3 sweep_ab.py DIR

(DIR in a directory .gitignore lists, e.g. .chipwork/parent.)  It builds
the earlier commit's pair_sweep.cu and second_sweep.cu into libraries of
their own (their C symbols are this tree's), each whole and stopped right
after its plane prologue (the sp_build call), this tree's stopped the
same way, the earlier indel_sweep.cu, extend_ungapped.cu, fm_search2.cu,
compact_cands.cu, pack_slots.cu, inject_known.cu, resolve_walk.cu,
inject_indels.cu, ref_window.cu, rescue_window.cu and merge_sites.cu
whole, the earlier extend_ungapped.cu stopped after its scans (that
tree's last/next-penalised scan, when it has one), copies of earlier
kernels stopped part-way (STOPS, where that tree's source has the marker:
K10 after its binary search, K5 storing a constant in place of the char,
K12 after staging its window and read) and this tree's K5 storing a
constant and K12 without its units' epilogues (THIS_STOPS): one nvcc per
library, all started together.  Then it runs
chip_smoke.py's phases, and on the steps chip_smoke.step_shapes reports it
takes the step's captured arguments and

- checks that the earlier kernels give this tree's outputs;
- times each kernel, 20 launches back to back between two CUDA events
  (median of 5 rounds), in turns: earlier, this, this, earlier.  K13's
  and K15's launches (whole and prologue-only) are issued from the host,
  on phase 10's and phase 11 (e)'s spliced full step; the others are
  captured in one CUDA graph (device time), since the wrapper's host
  work per call outlasts those kernels.  K8 runs on the linear step and
  config 6's full step; K6+K7's core and extra-slot launches on every
  step where chip_smoke holds them (linear, graph full, the spliced and
  config 6 steps, the genome linear step and a rescue chunk), with the
  earlier tree's scans-only copy; K1 on the linear, graph full, spliced
  full and config 6 full steps, and K17 (K1's lane-list mode, its lane
  list made outside the graph) on the spliced and config 6 full steps;
  K4 and K9 on the linear, graph full, spliced full, genome linear and
  config 6 full steps, with their bounds (chip_smoke.work) on those
  steps; K16 on the spliced, config 6 and long spliced lite and full
  steps (K16_STEPS) with its live slots; K20 on the genome linear and
  config 6 lite and full steps and the full step's re-search walk
  (K20_STEPS), with its live rows, its latency floor and this tree's
  time with every other live row dropped, and on the
  genome linear step also K19 (no mask) and K20 with every row live; K10
  on the graph full and config 6 full steps (K10_STEPS), with its
  search-only copy and its live slots (`k10_info`); K5 as a region on
  every step that captures it (the linear, graph, spliced, config 6,
  genome linear and long spliced steps and a rescue chunk): an earlier
  K5 of one plane and one start set a launch runs a launch a window,
  each behind that tree's wrapper work (`k5_one_launches`), against this
  tree's one launch, by CUDA graph and on the host clock (the enqueue of
  one call: `host_ms`, with and without the launch calls), with each
  tree's constant-store copy and the region's bound; K12 on each rescue
  chunk of phase 9's first paired batch (its padding jobs counted), with
  the earlier tree's copy stopped after its staging and the bound at the
  int8 and bf16 rates; K18 on the spliced slice's first merge and on each
  of config 6's merges (the earlier K18 through a shim of its own
  arguments: a [2, NB + 1] lob output and a scratch of sorted keys).  K9
  is also timed on the host clock;
- times this tree's K1 on the linear step with and without an L2
  access-policy window (persisting) over the fused table, in turns.

Both trees launch through this tree's wrappers (ops/), except the earlier
K5 of one window a launch and the earlier K18; only the C entry point differs, so the
arguments and the host work per launch are the same, except that an
earlier K10 without the spldir / splscore planes gets them zero-filled
(its wrapper did that).  The
earlier K15 must take both base pairs of a step in one launch, as this
tree's does; the earlier K8, K13 and K15 may lack this tree's trailing
scratch arguments (the scratch, its bytes).  Prints one `[sweep ab]
<step> {json}` line per step for K13 + K15, one `[sweep ab] <step>
<kernel> {json}` line per step for the others, then chip_smoke's own
lines.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import chip_smoke

SWEEPS = ("pair_sweep", "second_sweep")
# what a prologue-only copy writes, so that its planes stay live
PRO_SINK = {"pair_sweep": "A.bsel[(size_t)n * 2]", "second_sweep": "A.out[n]"}
# the earlier K6+K7's scans (the last/next-penalised columns), after which
# its scans-only copy stops
EXT_SCANS_END = "  __syncwarp();\n\n  const int total_pen = sP[L];"
# the earlier trees' kernels timed whole
WHOLE = ("indel_sweep", "extend_ungapped", "fm_search2", "compact_cands",
         "pack_slots", "inject_known", "resolve_walk", "inject_indels",
         "ref_window", "rescue_window", "merge_sites")
# K10 stopped after its binary search: every column writes a dead slot's
# outputs (its d2 the search's result, so that the search stays live)
K10_STOP = """  A.score[k] = -INJ_BIG;
  A.d1[k] = st;
  A.d2[k] = lo;
  A.x[k] = 1;
  A.kind[k] = 0;
  A.event[k] = -1;
  A.src[k] = c;
  return;
"""
# an earlier K12 (one block a job) stopped after staging its window and read:
# each output a staged word, so that the staging stays live
K12_STOP = """  if (threadIdx.x < RW_TOP)
    out[(long long)r * RW_TOP + threadIdx.x] =
        (int)(win[threadIdx.x] ^ wval[threadIdx.x] ^ rw[0] ^ rm[0]);
  return;
"""
# copies of earlier kernels stopped part-way, each writing every output it
# owes: K10 after its search, K5 storing a constant (its word and start
# loads then dead), K12 after its staging.  (marker in the source, the
# text put before it, or the text that replaces it)
STOPS = {
    ("inject_indels", "probe"): (
        "  const int idx = min(lo + t, A.E - 1);\n", K10_STOP, False),
    ("ref_window", "const"): ("  out[k] = ch;", "  out[k] = 4;", True),
    ("rescue_window", "staged"): (
        "  unsigned long long best[RW_TOP];\n", K12_STOP, False)}
# this tree's K5 storing a constant in place of each char (its start and
# word loads then dead), and its K12 without the epilogue of its units
# (their counts summed into the block's list, which then goes through the
# ticket and the job's merge as before)
THIS_STOPS = {("ref_window", "const"): (
    "    v[k] = (pos < 0 || pos >= lim) ? 4 : (int)((bits >> (2 * k)) & 3u);",
    "    v[k] = 4;", True),
    ("rescue_window", "noepi"): (
        "    // accumulator e of n-tile k: row j", """    {
      int x = 0;
      for (int k = 0; k < RW_TPW; ++k)
        x += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
      best += (uint32_t)x;
      continue;
    }
""", False)}
# the steps K4 and K9 are compared on
PACK_STEPS = ("linear", "graph full", "spliced full", "genome linear",
              "config6 full")
# the steps K10 is compared on; K5 is compared as a region on every step
# that captures it
K10_STEPS = ("graph full", "config6 full")
# the steps K16 and K20 are compared on
K16_STEPS = ("spliced lite", "spliced full", "config6 lite", "config6 full",
             "spliced long lite", "spliced long full")
K20_STEPS = ("genome linear", "config6 lite", "config6 full")
# an earlier K5 of one plane and one start set a launch: ref_words,
# n_words, n_text, starts, n_cands, W, margin, out, the stream
ONE_K5 = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
          ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# an L2 access-policy window on a stream: the persisting set-aside at its
# largest and a window over `bytes` from `base` whose hit ratio is the
# set-aside's share of it (on = 0: no window, the set-aside released)
L2_WINDOW_SRC = r"""
#include <cuda_runtime.h>
extern "C" int h2_l2_window(void* base, long long bytes, void* stream,
                            int on, float* ratio, long long* setaside) {
  int dev = 0, maxwin = 0, maxpers = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&maxwin, cudaDevAttrMaxAccessPolicyWindowSize,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&maxpers, cudaDevAttrMaxPersistingL2CacheSize,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize,
                           on ? (size_t)maxpers : 0);
  if (e != cudaSuccess) return (int)e;
  const long long nb = bytes < maxwin ? bytes : maxwin;
  cudaStreamAttrValue a = {};
  a.accessPolicyWindow.base_ptr = base;
  a.accessPolicyWindow.num_bytes = on ? (size_t)nb : 0;
  const float r = on ? (float)maxpers / (float)nb : 0.0f;
  a.accessPolicyWindow.hitRatio = r > 1.0f ? 1.0f : r;
  a.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  a.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  *ratio = a.accessPolicyWindow.hitRatio;
  *setaside = maxpers;
  e = cudaStreamSetAttribute((cudaStream_t)stream,
                             cudaStreamAttributeAccessPolicyWindow, &a);
  if (e == cudaSuccess && !on) e = cudaCtxResetPersistingL2Cache();
  return (int)e;
}
"""


def sweep_source(src, name, pro, stops=STOPS):
    """pair_sweep.cu / second_sweep.cu, stopped after sp_build if pro;
    extend_ungapped.cu stopped after its scans if pro; a source stopped at
    stops[(name, pro)] (the first marker after the kernel's __global__, or
    in a device function before it; None where that tree's kernel has no
    such point); any source whole if not pro."""
    text = open(os.path.join(src, name + ".cu")).read()
    if (name, pro) in stops:
        mark, put, swap = stops[(name, pro)]
        if mark not in text:
            return None
        at = text.find(mark, text.index("__global__"))
        at = text.index(mark) if at < 0 else at
        return text[:at] + put + text[at + len(mark) * swap:]
    if pro and name in SWEEPS:
        at = text.index("sp_build(", text.index("__global__"))
        end = text.index(");", at) + 2
        text = (text[:end] + "\n  __syncthreads();\n  if (threadIdx.x == 0) "
                f"{PRO_SINK[name]} = s.P[L] + (int)s.Pm[L];\n  return;"
                + text[end:])
    elif pro:
        if EXT_SCANS_END not in text:
            return None
        end = text.index(EXT_SCANS_END) + len("  __syncwarp();")
        text = (text[:end] + "\n  if (lane == 0) A.score[cand] = sP[L] + "
                "sC[L] + sLast[L - 1] + sNext[0];\n  return;" + text[end:])
    return text


def build_libs(kernels, parent_csrc):
    """{(tree, name, pro): (the library's C entry point, the number of
    this tree's arguments it takes before the stream)}."""
    out = os.path.join(kernels.BUILD_DIR, "sweep_ab")
    os.makedirs(out, exist_ok=True)
    jobs = []
    todo = [("parent", parent_csrc, name, pro) for name in SWEEPS
            for pro in (False, True)]
    todo += [("this", kernels.CSRC, name, True) for name in SWEEPS]
    todo += [("parent", parent_csrc, name, False) for name in WHOLE]
    todo.append(("parent", parent_csrc, "extend_ungapped", True))
    todo += [("parent", parent_csrc, name, stop) for name, stop in STOPS]
    todo += [("this", kernels.CSRC, name, stop) for name, stop in THIS_STOPS]
    for tree, src, name, pro in todo:
        text = sweep_source(src, name, pro,
                            THIS_STOPS if tree == "this" else STOPS)
        if text is None:
            continue
        tag = (f"{tree}_{name}_"
               f"{pro if isinstance(pro, str) else 'pro' if pro else 'whole'}")
        cu = os.path.join(out, tag + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"lib{tag}.so")
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC", "-shared", "-I", src, "-o", so, cu]
        nargs = len(kernels.KERNELS[name].argtypes) - 1
        this = sweep_source(kernels.CSRC, name, False)
        for arg in ("void* tickets", "void* scratch",
                    "long long scratch_bytes", "void* spldir",
                    "void* splscore"):
            # an earlier kernel without this tree's trailing scratch (or,
            # K10, zero-plane) arguments
            nargs -= arg in this and arg not in text
        if name == "ref_window" and "n_sets" not in text:
            nargs = -len(ONE_K5)      # one plane, one start set
        jobs.append(((tree, name, pro), so, nargs, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    cu = os.path.join(out, "l2_window.cu")
    with open(cu, "w") as f:
        f.write(L2_WINDOW_SRC)
    so = os.path.join(out, "libl2_window.so")
    jobs.append(((None, "l2_window", False), so, 0, subprocess.Popen(
        [kernels._nvcc(), *kernels.ARCH_FLAGS, "-Xcompiler", "-fPIC",
         "-shared", "-o", so, cu], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)))
    fns = {}
    # an earlier K5 of one plane and one start set a launch
    fns["k5_one"] = "n_sets" not in sweep_source(parent_csrc,
                                                 "ref_window", False)
    # an earlier K10 without the spldir / splscore planes (its wrapper
    # zero-filled them)
    fns["k10_fills"] = ("void* splscore" in sweep_source(
        kernels.CSRC, "inject_indels", False) and "void* splscore" not in
        sweep_source(parent_csrc, "inject_indels", False))
    for key, so, nargs, p in jobs:
        _, err = p.communicate()
        chip_smoke.check(p.returncode == 0, f"nvcc {key}: {err[-3000:]}")
        fn = getattr(ctypes.CDLL(so), "h2_" + key[1])
        if key[1] == "l2_window":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_longlong)]
            fn.restype = ctypes.c_int
            fns["l2_window"] = fn
            continue
        at = kernels.KERNELS[key[1]].argtypes
        if nargs < 0:
            at, nargs = ONE_K5 + [ctypes.c_void_p], -nargs
        fn.argtypes = at[:nargs] + at[-1:]
        fn.restype = ctypes.c_int
        fns[key] = (fn, nargs)
    return fns


def zeroed_k10(call):
    """call() with K10's wrapper zero-filling its output planes, as the
    wrapper of an earlier K10 without the spldir / splscore planes did
    for those two."""
    from hisat2_tpu_torch.ops import splice
    orig = splice._inject_indels_out
    splice._inject_indels_out = lambda N, J, dev: orig(N, J, dev).zero_()
    try:
        return call()
    finally:
        splice._inject_indels_out = orig


def k5_windows(kw):
    """The (plane, starts, margin) of each window one captured K5 call
    writes (this tree's call of every plane and start set, or an earlier
    tree's of one each), and its n_text and L."""
    if "planes" in kw:
        return ([(w, st, m) for st, m in zip(kw["starts"], kw["margins"])
                 for w in kw["planes"]], kw["n_text"], kw["L"])
    return [(kw["ref_words"], kw["starts"], kw["margin"])], kw["n_text"], \
        kw["L"]


def k5_one_launches(torch, kernels, fn, kw, launch=True):
    """An earlier K5 of one plane and one start set a launch, on the
    windows of one captured call: a launch a window, each behind the host
    work of that tree's wrapper (the two checks, the output, the device
    guard); launch=False: that wrapper work without the device guard and
    the launch."""
    f, _ = fn
    wins, n_text, L = k5_windows(kw)
    outs = []
    for w, st, m in wins:
        kernels.check_cuda("ref_words", w, torch.int32)
        kernels.check_cuda("starts", st, torch.int32)
        W = L + 2 * m
        out = torch.empty(tuple(st.shape) + (W,), dtype=torch.int32,
                          device=st.device)
        s = kernels.stream_of(st)
        if launch:
            with torch.cuda.device(s.device):
                err = f(w.data_ptr(), w.shape[0], n_text, st.data_ptr(),
                        st.numel(), W, m, out.data_ptr(), s.cuda_stream)
            chip_smoke.check(err == 0, f"earlier ref_window: launch error "
                             f"{err}")
        outs.append(out)
    return outs


def compare_k5(torch, kernels, fns, tag, kw):
    """K5 as a region on one step's captured call: the earlier tree's
    launches (a launch a window where its K5 takes one plane and one
    start set) against this tree's wrapper; equal windows, then the
    device time by CUDA graph in turns, each region's host enqueue in
    turns, and the earlier tree's constant-store copy; prints and
    returns them."""
    from hisat2_tpu_torch.ops import splice
    this = ((lambda: [o for row in splice.diag_chars_multi(**kw)
                      for o in row]) if "planes" in kw
            else (lambda: [splice.diag_chars(**kw)]))
    par = {}
    for stop in (False, "const"):
        fn = fns.get(("parent", "ref_window", stop))
        if fn is None:
            continue
        par[stop] = ((lambda fn=fn: k5_one_launches(torch, kernels, fn, kw))
                     if fns["k5_one"] else
                     (lambda fn=fn: through(torch, kernels, "ref_window", fn,
                                            this)))
    a, b = par[False](), this()
    chip_smoke.check(len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b)), f"{tag}: ref_window != "
        "parent")
    run = {"parent": par[False], "this": this}
    turns = ("parent", "this", "this", "parent")
    t = [graph_ms(torch, run[tr]) for tr in turns]
    h = [host_ms(torch, run[tr]) for tr in turns]
    wins, _, _ = k5_windows(kw)
    res = {"parent": [t[0], t[3]], "this": [t[1], t[2]],
           "host_parent": [h[0], h[3]], "host_this": [h[1], h[2]],
           "windows": len(wins),
           "chars": sum(st.numel() * (kw["L"] + 2 * m) for _, st, m in wins)}
    if "const" in par:
        res["parent_const"] = [graph_ms(torch, par["const"])
                               for _ in range(2)]
    fn = fns.get(("this", "ref_window", "const"))
    if fn is not None and "planes" in kw:
        res["this_const"] = [graph_ms(torch, lambda: through(
            torch, kernels, "ref_window", fn, this)) for _ in range(2)]
    # each region's wrapper work on the host without its launches (the
    # device guard, the C call)
    k = kernels.KERNELS["ref_window"]
    k.launch = lambda *args, stream: None
    try:
        res["host_this_nolaunch"] = host_ms(torch, this)
    finally:
        del k.launch
    if fns["k5_one"]:
        fn = fns[("parent", "ref_window", False)]
        res["host_parent_nolaunch"] = host_ms(torch, lambda: k5_one_launches(
            torch, kernels, fn, kw, launch=False))
    res["bound_ms"], _ = chip_smoke.work(torch, "ref_window", kw, b)
    print(f"[sweep ab] {tag} ref_window: {json.dumps(res)}", flush=True)
    return res


def through(torch, kernels, name, fn, call):
    """call() with the wrapper of kernel `name` launching the C function
    fn = (function, number of arguments before the stream) in place of
    this tree's."""
    if fn is None:
        return call()
    k = kernels.KERNELS[name]
    f, nargs = fn

    def launch(*args, stream):
        with torch.cuda.device(stream.device):
            err = f(*args[:nargs], stream.cuda_stream)
        chip_smoke.check(err == 0, f"{name}: launch error {err}")
    k.launch = launch
    try:
        return call()
    finally:
        del k.launch


def compare_walk(torch, kernels, fns, tag, key, kw, info):
    """K20 on one step's arguments: the earlier tree's kernel against this
    tree's wrapper, equal outputs, then the device time by CUDA graph in
    turns."""
    from hisat2_tpu_torch.ops import resolve
    old = fns[("parent", "resolve_walk", False)]

    def pair(a):
        return (lambda: through(torch, kernels, "resolve_walk", old,
                                lambda: resolve.resolve_rows_sparse(**a)),
                lambda: resolve.resolve_rows_sparse(**a))

    def turns(par, thd, what):
        chip_smoke.check(torch.equal(par(), thd()), f"{tag}: {what} != "
                         "parent")
        t = [graph_ms(torch, par if tr == "parent" else thd)
             for tr in ("parent", "this", "this", "parent")]
        return {"parent": [t[0], t[3]], "this": [t[1], t[2]]}
    res = turns(*pair(kw), key)
    if kw["live"] is not None:
        # every other live row dropped: the time halves where the walks'
        # random sectors bind, and stays where the longest chain does
        lv = kw["live"]
        half = dict(kw, live=lv & (torch.cumsum(lv.to(torch.int32), 0) % 2
                                   == 0))
        res["this_half_live"] = [graph_ms(
            torch, lambda: resolve.resolve_rows_sparse(**half))
            for _ in range(2)]
    if tag == "genome linear":
        # every row walked: K19 (no mask), and K20 with every row live
        for mode, lv in (("dense", None), ("full_mask", torch.ones_like(
                kw["live"]))):
            res[mode] = turns(*pair(dict(kw, live=lv)), mode)
    res.update(info)
    print(f"[sweep ab] {tag} {key}: {json.dumps(res)}", flush=True)
    return res


def compare_k9(torch, kernels, fns, tag, kw, info):
    """K9 on one step's block dicts: the earlier tree's kernel through this
    tree's wrapper against this tree's; equal outputs, then the device
    time by CUDA graph in turns and each one's host enqueue in turns;
    prints and returns them."""
    from hisat2_tpu_torch.ops import compact
    old = fns[("parent", "pack_slots", False)]
    run = {"parent": lambda: through(torch, kernels, "pack_slots", old,
                                     lambda: compact.pack_slots(**kw)),
           "this": lambda: compact.pack_slots(**kw)}
    a = chip_smoke.flat_outputs(run["parent"]())
    b = chip_smoke.flat_outputs(run["this"]())
    chip_smoke.check(len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b)), f"{tag}: pack_slots != "
        "parent")
    turns = ("parent", "this", "this", "parent")
    t = [graph_ms(torch, run[tr]) for tr in turns]
    h = [host_ms(torch, run[tr]) for tr in turns]
    res = {"parent": [t[0], t[3]], "this": [t[1], t[2]],
           "host_parent": [h[0], h[3]], "host_this": [h[1], h[2]]}
    res.update(info)
    print(f"[sweep ab] {tag} pack_slots: {json.dumps(res)}", flush=True)
    return res


def l2_window_ab(torch, window, fn, blocked):
    """K1's device time by CUDA graph on a fresh stream without and with
    an L2 access-policy window (persisting) over the fused table, in
    turns (off, on, on, off); its outputs equal either way."""
    res = {"off": [], "on": []}
    ref = chip_smoke.flat_outputs(fn())
    for mode in ("off", "on", "on", "off"):
        s = torch.cuda.Stream()
        ratio, setaside = ctypes.c_float(0), ctypes.c_longlong(0)
        err = window(blocked.data_ptr(), blocked.numel() * 4, s.cuda_stream,
                     int(mode == "on"), ctypes.byref(ratio),
                     ctypes.byref(setaside))
        chip_smoke.check(err == 0, f"L2 window: error {err}")
        with torch.cuda.stream(s):
            res[mode].append(graph_ms(torch, fn))
            out = chip_smoke.flat_outputs(fn())
        torch.cuda.synchronize()
        chip_smoke.check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                         "fm_search2 under the L2 window != without")
        if mode == "on":
            res.update(hit_ratio=ratio.value, set_aside=setaside.value,
                       window_bytes=blocked.numel() * 4)
    return res


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


def host_ms(torch, fn, reps=20, rounds=5):
    """Host time of one call of fn (its enqueue: Python, the wrapper,
    the launches), `reps` calls on the host clock after the card is idle,
    median of `rounds`; the card is not waited on inside a round."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
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


def compare_graphed(torch, kernels, fns, tag, key, call, info):
    """Kernel `key` (a name, or name/role) of both trees on one step's
    arguments (call() runs its wrapper): equal outputs, then the device
    time by CUDA graph in turns (earlier, this, this, earlier), and the
    earlier tree's scans-only copy where one was built; prints and returns
    them."""
    name = key.split("/")[0]
    src = "fm_search2" if name == "search_lanes_live" else name
    run = {"parent": lambda: through(torch, kernels, name,
                                     fns[("parent", src, False)], call),
           "this": call}
    if name == "inject_indels" and fns["k10_fills"]:
        par = run["parent"]
        run["parent"] = lambda: zeroed_k10(par)
    old = chip_smoke.flat_outputs(run["parent"]())
    new = chip_smoke.flat_outputs(run["this"]())
    chip_smoke.check(len(old) == len(new), f"{tag}: {key} output arity")
    for a, b in zip(new, old):
        chip_smoke.check((a is None and b is None) or torch.equal(a, b),
                         f"{tag}: {key} != parent")
    t = [graph_ms(torch, run[tr]) for tr in ("parent", "this", "this",
                                             "parent")]
    res = {"parent": [t[0], t[3]], "this": [t[1], t[2]]}
    pro = fns.get(("parent", name, True))
    if name == "extend_ungapped" and pro is not None:
        res["parent_scans_only"] = graph_ms(
            torch, lambda: through(torch, kernels, name, pro, call))
    for nm, stop in STOPS:
        fn = fns.get(("parent", nm, stop))
        if nm == name and fn is not None:
            res[f"parent_{stop}"] = [graph_ms(torch, lambda: through(
                torch, kernels, name, fn, call)) for _ in range(2)]
    for nm, stop in THIS_STOPS:
        fn = fns.get(("this", nm, stop))
        if nm == name and fn is not None:
            res[f"this_{stop}"] = [graph_ms(torch, lambda: through(
                torch, kernels, name, fn, call)) for _ in range(2)]
    res.update(info)
    print(f"[sweep ab] {tag} {key}: {json.dumps(res)}", flush=True)
    return res


def k18_parent(torch, kernels, fn, kw):
    """The earlier K18 (its C entry point: the 14 inputs, cap, m, NB (0:
    no bucket index), out [6, cap], lob_out [2, NB + 1], a scratch of 4 x
    512 sorted keys) on one merge's arguments; its outputs as this tree's
    wrapper returns them."""
    f, _ = fn
    kd = kw["kd"]
    cap, m = kd.shape[0], kw["nkd"].shape[0]
    lob = kw.get("lob_kd") is not None
    NB = kw["lob_kd"].shape[0] - 1 if lob else 0
    out = torch.empty((6, cap), dtype=torch.int32, device=kd.device)
    lob_out = (torch.empty((2, NB + 1), dtype=torch.int32, device=kd.device)
               if lob else out)
    scratch = torch.empty((4, 512), dtype=torch.int64, device=kd.device)
    ptrs = [(kw[k] if kw.get(k) is not None else kd).data_ptr() for k in (
        "kd", "ka", "rd", "ka_s", "kd_s", "rd_a", "nkd", "nka", "nrd",
        "lob_kd", "lob_ka", "bins_kd", "bins_ka", "wts")]
    s = kernels.stream_of(kd)
    with torch.cuda.device(s.device):
        err = f(*ptrs, cap, m, NB, out.data_ptr(), lob_out.data_ptr(),
                scratch.data_ptr(), s.cuda_stream)
    chip_smoke.check(err == 0, f"earlier merge_sites: launch error {err}")
    res = tuple(out.unbind(0))
    return res + tuple(lob_out.unbind(0)) if lob else res


def compare_k18(torch, kernels, fns, tag, kw):
    """K18 on one merge's arguments: the earlier tree's launches (through
    k18_parent) against this tree's wrapper; equal outputs, then the
    device time by CUDA graph in turns; prints and returns them."""
    from hisat2_tpu_torch.ops import sites
    old = fns[("parent", "merge_sites", False)]
    run = {"parent": lambda: k18_parent(torch, kernels, old, kw),
           "this": lambda: sites.merge_sorted_tabs(**kw)}
    a, b = run["parent"](), run["this"]()
    chip_smoke.check(len(a) == len(b) and all(
        torch.equal(x, y) for x, y in zip(a, b)), f"{tag}: merge_sites != "
        "parent")
    t = [graph_ms(torch, run[tr]) for tr in ("parent", "this", "this",
                                             "parent")]
    res = {"parent": [t[0], t[3]], "this": [t[1], t[2]],
           "cap": kw["kd"].shape[0], "m": kw["nkd"].shape[0],
           "m_real": int((kw["nkd"] < 2 ** 31 - 2).sum()),
           "NB": (kw["lob_kd"].shape[0] - 1 if kw.get("lob_kd") is not None
                  else None)}
    res["bound_ms"], res["bound_by"] = chip_smoke.work(torch, "merge_sites",
                                                       kw, b)
    print(f"[sweep ab] {tag} merge_sites: {json.dumps(res)}", flush=True)
    return res


def k12_info(torch, kw):
    """K12's shape on one rescue chunk: its jobs, the padding ones (no
    ACGT column), L, W, and its bound at the int8 and bf16 rates."""
    from hisat2_tpu_torch.ops import rescue
    R, L = kw["reads"].shape
    rd = kw["reads"]
    bound, by = chip_smoke.work(torch, "rescue_window", kw,
                                rescue.rescue_window(**kw))
    return {"R": R, "L": L, "W": kw["W"],
            "padding_jobs": int((~((rd >= 0) & (rd < 4)).any(1)).sum()),
            "bound_ms": bound, "bound_by": by,
            "bound_bf16_ms": chip_smoke.rescue_bf16_bound(kw)}


def k16_info(torch, kw):
    """K16's shape on one step's arguments: its slots, the live ones (the
    slots that walk the read) and their columns."""
    live, tot, ok = chip_smoke.known_live(torch, kw)
    return {"N": ok.shape[0], "C": kw["starts"].shape[1], "J": ok.shape[1],
            "L": kw["reads"].shape[1], "slots": kw["slots"], "live": live,
            "live_share": live / max(tot, 1),
            "walked_cols": int((ok * kw["lens"][:, None]).sum()),
            "sites": int(kw["tabs"]["ss_kd"].shape[0]),
            "snv": kw.get("snv1_w") is not None}


def k10_info(torch, kw):
    """K10's shape on one step's arguments: its slots, the live ones (the
    slots that walk the read: splice.indel_probes) and their columns."""
    from hisat2_tpu_torch.ops import splice
    pr = splice.indel_probes(*(kw[k] for k in (
        "starts", "valid", "lens", "reads", "ip", "ilen", "ins_chars",
        "rkey", "r_ilen", "r_row")), kw["slots"])
    live = pr["live"]
    N, J = live.shape
    return {"N": N, "C": kw["starts"].shape[1], "J": J,
            "L": kw["reads"].shape[1], "slots": kw["slots"],
            "E": kw["ip"].shape[0], "in_read": int(pr["okd"].sum()),
            "live": int(live.sum()), "live_share": float(live.float().mean()),
            "walked_cols": int((live * kw["lens"][:, None]).sum())}


def k20_info(torch, kw):
    """K20's shape on one step's arguments: its rows, the live ones and
    the distinct live rows, and its latency floor (chip_smoke.walk_chain
    at the pointer chase's latency)."""
    nlive, M, dist = chip_smoke.walk_live(torch, kw)
    res = {"M": M, "P": kw.get("P", 1), "live": nlive,
           "live_share": nlive / max(M, 1), "distinct_live": dist}
    if "ns" in chip_smoke.CHASE:
        chain = chip_smoke.walk_chain(torch, kw)
        res.update(chain=chain, dependent_load_ns=chip_smoke.CHASE["ns"],
                   latency_floor_ms=chain * chip_smoke.CHASE["ns"] * 1e-6)
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
    from hisat2_tpu_torch.ops import compact, extend, rescue, search, splice
    kernels.load()
    fns = build_libs(kernels, os.path.join(os.path.abspath(sys.argv[1]),
                                           "hisat2_tpu_torch", "csrc"))
    from hisat2_tpu_torch.ops import kernel_twins
    twins = kernel_twins()
    done = {"sweeps": [], "indel_sweep": [], "extend_ungapped": [],
            "fm_search2": [], "compact_cands": [], "pack_slots": [],
            "inject_known": [], "resolve_walk": [], "inject_indels": [],
            "ref_window": [], "rescue_window": [], "merge_sites": []}
    shapes = chip_smoke.step_shapes

    def hook(splice_mod, step, cap, k5=None):
        shapes(splice_mod, step, cap, k5)
        if step in ("spliced full", "config6 full"):
            done["sweeps"].append(compare_step(
                torch, kernels, splice, fns, step, cap["pair_sweep"],
                cap["second_sweep"]))
        if step in ("linear", "config6 full"):
            kw = cap["indel_sweep"]
            N, C, W = kw["ch"].shape
            L = kw["reads"].shape[1]
            done["indel_sweep"].append(compare_graphed(
                torch, kernels, fns, step, "indel_sweep",
                lambda: splice.self_indel_sweep(**kw),
                {"live_share": float(kw["valid"].float().mean()), "N": N,
                 "C": C, "W": W, "L": L,
                 "G": splice.indel_sweep_gap(L, W, kw["max_gap"],
                                             kw["prm"]),
                 "snv": kw.get("snv1_w") is not None}))
        for key in ("extend_ungapped", "extend_ungapped/extra"):
            if key not in cap:
                continue
            kw = cap[key]
            st = kw["cand_start"]
            live_g, dead_g = chip_smoke.extend_groups(st)
            done["extend_ungapped"].append(compare_graphed(
                torch, kernels, fns, step, key,
                lambda: extend.extend_grouped(**kw),
                {"live_share": float((st >= 0).float().mean()),
                 "groups": int((live_g + dead_g).sum()), "B": st.shape[0],
                 "C": st.shape[1], "L": kw["reads"].shape[1],
                 "snv": kw.get("snv1_win") is not None}))
        if step in ("linear", "graph full", "spliced full", "config6 full"):
            kw = cap["fm_search2"]
            done["fm_search2"].append(compare_graphed(
                torch, kernels, fns, step, "fm_search2",
                lambda: search.partial_search2(**kw),
                {"N": kw["reads"].shape[0], "L": kw["reads"].shape[1],
                 "cols": kw["blocked"].shape[1]}))
            if step == "linear":
                res = l2_window_ab(torch, fns["l2_window"],
                                   lambda: search.partial_search2(**kw),
                                   kw["blocked"])
                print(f"[sweep ab] linear fm_search2 L2 window: "
                      f"{json.dumps(res)}", flush=True)
            kl = cap.get("search_lanes_live")
            if kl is not None and kl["reads"].shape[0] > kl.get("chunk",
                                                                2048):
                lanes = torch.nonzero(kl["cut"] >= kl["min_hit_len"])[
                    :, 0].to(torch.int32).contiguous()
                args = {k: v for k, v in kl.items() if k not in ("cut",
                                                                 "chunk")}
                args["lens"] = kl["cut"]
                done["fm_search2"].append(compare_graphed(
                    torch, kernels, fns, step, "search_lanes_live",
                    lambda: search.partial_search2(**args, lanes=lanes),
                    {"N": kl["reads"].shape[0], "lanes": lanes.shape[0],
                     "L": kl["reads"].shape[1],
                     "cols": kl["blocked"].shape[1]}))
        if step in PACK_STEPS:
            for name in ("compact_cands", "pack_slots"):
                kw = cap[name]
                bound, by = chip_smoke.work(torch, name, kw,
                                            twins[name][0](**kw))
                info = {"bound_ms": bound, "bound_by": by}
                if name == "compact_cands":
                    N, H = kw["top"].shape
                    J = H * kw["P"] + (kw["top2"].shape[1] * kw["P2"]
                                       if kw.get("top2") is not None
                                       else 0)
                    info.update(N=N, J=J, C=kw["C"],
                                sampled=kw.get("offs") is not None)
                    done[name].append(compare_graphed(
                        torch, kernels, fns, step, name,
                        lambda: compact.compact_cands(**kw), info))
                else:
                    bl = kw["blocks"]
                    info.update(N=bl[0]["score"].shape[0],
                                K=sum(b["score"].shape[1] for b in bl),
                                blocks=len(bl), Mdev=kw["Mdev"],
                                spill=kw["use_spill"])
                    done[name].append(compare_k9(torch, kernels, fns, step,
                                                 kw, info))
        if step in K16_STEPS:
            kw = cap["inject_known"]
            done["inject_known"].append(compare_graphed(
                torch, kernels, fns, step, "inject_known",
                lambda: splice.inject_known(**kw), k16_info(torch, kw)))
        if step in K10_STEPS:
            kw = cap["inject_indels"]
            info = k10_info(torch, kw)
            # this tree's probes alone: no candidate valid, so no slot is
            # listed or walked (every search still runs)
            none = dict(kw, valid=torch.zeros_like(kw["valid"]))
            info["this_none_live"] = [graph_ms(
                torch, lambda: splice.inject_indels(**none)) for _ in range(2)]
            done["inject_indels"].append(compare_graphed(
                torch, kernels, fns, step, "inject_indels",
                lambda: splice.inject_indels(**kw), info))
        if "ref_window" in cap:
            done["ref_window"].append(compare_k5(torch, kernels, fns, step,
                                                 cap["ref_window"]))
        if step in K20_STEPS:
            for key in ("resolve_walk", "resolve_walk/research"):
                if key not in cap:
                    continue
                done["resolve_walk"].append(compare_walk(
                    torch, kernels, fns, step, key, cap[key],
                    k20_info(torch, cap[key])))
        if "rescue_window" in cap:
            kw = cap["rescue_window"]
            done["rescue_window"].append(compare_graphed(
                torch, kernels, fns, step, "rescue_window",
                lambda: rescue.rescue_window(**kw), k12_info(torch, kw)))
        if "merge_sites" in cap:
            done["merge_sites"].append(compare_k18(torch, kernels, fns, step,
                                                   cap["merge_sites"]))
    chip_smoke.step_shapes = hook
    rc = chip_smoke.main()
    n = {k: len(v) for k, v in done.items()}
    chip_smoke.check(n["sweeps"] == 2 and n["indel_sweep"] == 2
                     and n["extend_ungapped"] >= 8 and n["fm_search2"] >= 6
                     and n["compact_cands"] == 5 and n["pack_slots"] == 5
                     and n["inject_known"] == len(K16_STEPS)
                     and n["resolve_walk"] == len(K20_STEPS) + 1
                     and n["inject_indels"] == len(K10_STEPS)
                     and n["ref_window"] >= 2 and n["rescue_window"] >= 1
                     and n["merge_sites"] >= 1,
                     f"steps compared: {n}")
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Build and bind the hand-written Hopper kernels (csrc/*.cu).

Route (b) of the port's kernel rule: the CUDA C++ sources have a plain C
interface, `nvcc` compiles each of them for sm_90a (one process per
source, all started together) and links them into one shared library
under hisat2_tpu_torch/build/ on first use, and ctypes binds it (the same
pattern as hisat2_tpu/native/__init__.py:_build, with nvcc).  Every C
entry point launches on the caller's stream and returns cudaGetLastError();
a non-zero code raises here.  Nothing is built or loaded at import time.

Each kernel is a `Kernel` object in KERNELS with a launch counter that
counts successful launches and nothing else; the ops-level wrappers
(ops/search.py, ops/compact.py, ops/splice.py, ops/extend.py,
ops/rescue.py, ops/sites.py, ops/resolve.py) are its only callers.  Two
kernels may share a C symbol (kernel 1 and its lane-list mode, K17): each
counts its own launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libh2_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


class Kernel:
    """One CUDA kernel: its C symbol, ctypes signature and launch count."""

    def __init__(self, name, symbol, argtypes, source, replaces):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args, stream):
        """Launch on `stream` (stream_of's torch.cuda.Stream) with its
        device selected: the C entry point's runtime calls (the shared
        memory attribute, the launch, cudaGetLastError) act on the
        current device, so a launch for cuda:1 must not run while cuda:0
        is current."""
        fn = getattr(load(), self.symbol)
        with torch.cuda.device(stream.device):
            err = fn(*args, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {err} "
                f"({load().h2_error_string(err).decode()})")
        self.launches += 1


KERNELS = {k.name: k for k in (
    Kernel("fm_search2", "h2_fm_search2",
           [_P] * 6 + [_I] * 11 + [_P] * 11 + [_P],
           "hisat2_tpu_torch/csrc/fm_search2.cu",
           "hisat2_tpu/ops/search.py:409 partial_search2 (+ :326 "
           "_finish_events)"),
    Kernel("search_lanes_live", "h2_fm_search2",
           [_P] * 6 + [_I] * 11 + [_P] * 11 + [_P],
           "hisat2_tpu_torch/csrc/fm_search2.cu",
           "hisat2_tpu/ops/search.py:267 search_lanes_live (kernel 1's "
           "lane-list mode)"),
    Kernel("ref_window", "h2_ref_window", [_P, _P],
           "hisat2_tpu_torch/csrc/ref_window.cu",
           "hisat2_tpu/ops/rank.py:132 ref_chars_block (via "
           "ops/splice.py:277 diag_chars; every plane and start set of a "
           "step in one launch)"),
    Kernel("extend_ungapped", "h2_extend_ungapped",
           [_P] * 10 + [_LL, _I, _I, _I, _I, _LL] + [_I] * 6 + [_P] * 8
           + [_P],
           "hisat2_tpu_torch/csrc/extend_ungapped.cu",
           "hisat2_tpu/ops/extend.py:225 extend_grouped (+ :72 "
           "pen_planes, with the SNV branch :100-111)"),
    Kernel("indel_sweep", "h2_indel_sweep",
           [_P] * 8 + [_LL] + [_I] * 10 + [_P, _P, _P, _I, _P, _LL, _P],
           "hisat2_tpu_torch/csrc/indel_sweep.cu",
           "hisat2_tpu/ops/splice.py:952 self_indel_sweep"),
    Kernel("compact_cands", "h2_compact_cands",
           [_P] * 15 + [_I] * 13 + [_P] * 13 + [_LL, _P],
           "hisat2_tpu_torch/csrc/compact_cands.cu",
           "hisat2_tpu/ops/resolve.py:174-186 resolve_consecutive (full "
           "SA) + align/pipeline.py:772-998 compaction (ops/compact.py:"
           "22-62)"),
    Kernel("pack_slots", "h2_pack_slots",
           [_P, _P] + [_I] * 8 + [_P] * 6 + [_LL, _P],
           "hisat2_tpu_torch/csrc/pack_slots.cu",
           "hisat2_tpu/align/pipeline.py:1211-1375 slot merge, top-Mdev, "
           "flags, spill layout"),
    Kernel("inject_indels", "h2_inject_indels",
           [_P] * 19 + [_LL] + [_I] * 10 + [_P] * 9 + [_P],
           "hisat2_tpu_torch/csrc/inject_indels.cu",
           "hisat2_tpu/ops/splice.py:838 inject_indels (+ ops/extend.py:124 "
           "live_pen_prefix)"),
    Kernel("rescue_window", "h2_rescue_window",
           [_P, _I, _LL, _P, _P, _I, _I, _I, _P, _P, _P, _LL] + [_P],
           "hisat2_tpu_torch/csrc/rescue_window.cu",
           "hisat2_tpu/ops/rescue.py:25 rescue_candidates (the one-hot "
           "cross-correlation and top_k, :39-59)"),
    Kernel("pair_sweep", "h2_pair_sweep",
           [_P] * 10 + [_LL] + [_I] * 22 + [_P, _P, _I] + [_P] * 4
           + [_LL, _P],
           "hisat2_tpu_torch/csrc/pair_sweep.cu",
           "hisat2_tpu/ops/splice.py:300 pair_sweep (+ :1318 select_pairs, "
           "align/pipeline.py:1389-1396 base pairs)"),
    Kernel("second_sweep", "h2_second_sweep",
           [_P] * 24 + [_I] * 4 + [_LL] + [_I] * 15 + [_P, _P, _LL, _P],
           "hisat2_tpu_torch/csrc/second_sweep.cu",
           "hisat2_tpu/ops/splice.py:1107 second_sweep (+ :192 "
           "table_searchsorted; both base pairs of align/pipeline.py:"
           "1389-1412 in one launch)"),
    Kernel("inject_known", "h2_inject_known",
           [_P] * 21 + [_I] * 3 + [_P] * 4 + [_LL] + [_I] * 10 + [_P]
           + [_P],
           "hisat2_tpu_torch/csrc/inject_known.cu",
           "hisat2_tpu/ops/splice.py:629 inject_known (+ :192 "
           "table_searchsorted, ops/extend.py:124 live_pen_prefix)"),
    Kernel("merge_sites", "h2_merge_sites",
           [_P] * 14 + [_I] * 3 + [_P] * 3 + [_P],
           "hisat2_tpu_torch/csrc/merge_sites.cu",
           "hisat2_tpu/align/splice_db.py:40 _merge_sorted_tabs (+ :72 "
           "lob_add)"),
    Kernel("resolve_walk", "h2_resolve_walk",
           [_P, _LL, _P, _P, _LL, _I, _I, _P, _I, _P, _LL, _P] + [_P],
           "hisat2_tpu_torch/csrc/resolve_walk.cu",
           "hisat2_tpu/ops/resolve.py:29 resolve_rows (+ :107 "
           "resolve_rows_sparse)"),
)}

_lib = None
BUILD_LOG = os.path.join(BUILD_DIR, "nvcc.log")


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (sm_90a) to build")
    return path


def build(force: bool = False) -> float:
    """Compile csrc/*.cu into BUILD_DIR/libh2_kernels.so when a source is
    newer than the library (or always, with force): one nvcc process per
    source, all started together, then one link.  Returns the seconds
    spent (0 when the library was current).  The ptxas register/spill
    report of the last build is kept in BUILD_DIR/nvcc.log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, LIB_NAME)
    srcs = _sources()
    if not force and os.path.exists(so) and all(
            os.path.getmtime(s) <= os.path.getmtime(so) for s in srcs):
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs, procs, log = [], [], []
    for s in srcs:
        if not s.endswith(".cu"):
            continue
        obj = os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo",
               "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c", s, "-o", obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = None
    for cmd, p in procs:
        out, err = p.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if p.returncode != 0 and failed is None:
            failed = (p.returncode, err)
    if failed is None:
        tmp = f"{so}.{tag}.tmp"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            failed = (r.returncode, r.stderr)
    with open(BUILD_LOG, "w") as f:
        f.write("\n".join(log))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                           f"{failed[1][-4000:]}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def load():
    """The bound kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, LIB_NAME))
        for k in KERNELS.values():
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
        lib.h2_error_string.argtypes = [ctypes.c_int]
        lib.h2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch_info(symbol: str, *args, n: int = 5) -> dict:
    """A kernel's launch at these shapes, as the CUDA runtime reports it,
    from its C entry point `symbol` (int arguments, then an int[n] it
    fills): registers per thread, static and dynamic shared bytes,
    threads per block, blocks per SM (0 where a block does not fit) and,
    where n >= 6, local bytes per thread (spills and stack) and, where n
    = 7 (K13, K15), the global scratch bytes per block."""
    out = (ctypes.c_int * n)()
    fn = getattr(load(), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol} failed with error {err}")
    return dict(zip(("regs", "static_smem", "smem", "threads",
                     "blocks_per_sm", "local_bytes", "scratch_per_block"),
                    out))


def scratch(symbol: str, argtypes, *args, dev):
    """The global scratch a kernel asks for at these shapes, from its C
    query `symbol` (arguments of the ctypes types `argtypes`, the last one
    the count of lanes or candidates, then a long long it fills with the
    bytes): None where it needs none, else an uninitialised byte buffer on
    `dev`.  The kernel launches as many blocks as the buffer it is given
    holds (scratch_args), so a smaller one only makes each block walk more
    lanes."""
    fn = getattr(load(), symbol)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nbytes = ctypes.c_longlong(0)
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.byref(nbytes))
    if err != 0:
        raise RuntimeError(f"{symbol} failed with error {err}")
    if nbytes.value == 0:
        return None
    return torch.empty(nbytes.value, dtype=torch.uint8, device=dev)


def scratch_args(buf):
    """The (pointer, bytes) a kernel entry point takes for its scratch."""
    return (None, 0) if buf is None else (buf.data_ptr(), buf.numel())


def stream_of(t):
    """PyTorch's current CUDA stream on t's device (Kernel.launch passes
    its pointer value and selects its device)."""
    return torch.cuda.current_stream(t.device)


def check_cuda(name, t, dtype, shape=None):
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")

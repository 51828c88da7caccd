"""hisat2_tpu_torch — the PyTorch/CUDA port of hisat2_tpu for NVIDIA Hopper.

The JAX package `hisat2_tpu` stays the reference: every module here has a
counterpart there and is held bit for bit against it on the same inputs.
This package imports torch and never jax, and nothing of hisat2_tpu: the
numpy host modules it needs (index format and builder, variant catalog,
.ht2 conversion, read and SAM I/O, scoring, MAPQ, RNG, the host hybrid
replay, pairing and the paired give-up replay, the C++ helpers in native/)
are copies at the same relative paths, and the numpy host phase that lives
beside JAX code in hisat2_tpu/align/pipeline.py is carried into
align/host.py.

Layout (mirrors hisat2_tpu):
  utils/    uint32 emulation on int64 tensors (intops), 2-bit packing,
            tracing
  index/    the FM index, its builder and variant catalog, and
            TorchFMIndex: the device-resident index (to_device)
  io/       FASTA/FASTQ/tabbed readers, the SAM writer, --un/--al sinks
  native/   SA-IS and the SAM line formatter in C++, built with g++ into
            hisat2_tpu_torch/build/ on first use
  ops/      rank/LF, FM search, SA resolve, compaction, extension, sweeps,
            mate-rescue windows; each hand kernel has a plain torch twin
            in the same module
  kernels/  builds csrc/*.cu with nvcc for sm_90a and binds them (ctypes)
  csrc/     the CUDA C++ kernels
  align/    TorchAligner (device step + host phase + mate rescue), driver,
            pairing, host replays
  cli/      `python -m hisat2_tpu_torch align|build`

Scope: unpaired and paired reads, DNA and spliced RNA, against linear,
--ss and SNP graph indexes, with a full or a sampled suffix array, and
against sharded genome-scale indexes: unpaired reads in every mode,
paired reads in DNA mode on a linear index.  The paired runs the JAX
package fails on (spliced, or on a graph index, over several shards) are
refused with its fault named (align/pipeline.py).
"""

__version__ = "0.1.0"

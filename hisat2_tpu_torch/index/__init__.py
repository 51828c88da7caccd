"""hisat2_tpu_torch.index: the device-resident index (format.to_device).

The on-disk format, the numpy builder and the variant catalog are
hisat2_tpu's, which have no JAX in them; they are re-exported here for the
port's callers."""

from hisat2_tpu.index.builder import build_fm_index  # noqa: F401
from hisat2_tpu.index.format import FMIndex  # noqa: F401
from hisat2_tpu.index.variants import VariantDB, attach_variants  # noqa: F401

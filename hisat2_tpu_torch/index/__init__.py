"""hisat2_tpu_torch.index: the FM index, its builder and variant catalog
(the port's copies of hisat2_tpu/index/), and the device-resident index
(format.to_device)."""

from .builder import build_fm_index  # noqa: F401
from .format import FMIndex, ShardedFMIndex  # noqa: F401
from .variants import VariantDB, attach_variants  # noqa: F401

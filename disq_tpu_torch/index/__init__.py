"""BAM indexes: the splitting index (SBI) and the BAI."""

from disq_tpu_torch.index.bai import (  # noqa: F401
    BaiIndex,
    build_bai,
    merge_bai_fragments,
    reg2bin,
)
from disq_tpu_torch.index.sbi import SbiIndex  # noqa: F401

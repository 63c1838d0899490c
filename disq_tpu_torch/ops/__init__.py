"""Device operations: each kernel's wrapper and plain version, and the
torch-op reductions. Importing builds no kernel: a kernel is built with
``nvcc`` at its first launch on ``cuda``."""

from disq_tpu_torch.ops.depth import window_depth  # noqa: F401
from disq_tpu_torch.ops.flagstat import (  # noqa: F401
    FLAGSTAT_FIELDS,
    flagstat_counts,
)
from disq_tpu_torch.ops.parse import (  # noqa: F401
    parse_fixed_words,
    parse_fixed_words_pallas,
)

"""disq_tpu_torch — the PyTorch/CUDA port of ``disq_tpu``.

The same storages, datasets and outputs as the JAX package, with every
device kernel written by hand for NVIDIA Hopper (``csrc/``) and the rest
as torch ops or host code. It never imports ``jax`` or ``disq_tpu``.
"""

from disq_tpu_torch.api import (  # noqa: F401
    BaiWriteOption,
    CraiWriteOption,
    FileCardinalityWriteOption,
    ReadsDataset,
    ReadsFormatWriteOption,
    ReadsStorage,
    SbiWriteOption,
    StageManifestWriteOption,
    TempPartsDirectoryWriteOption,
    ValidationStringency,
    WriteOption,
)
from disq_tpu_torch.runtime.errors import (  # noqa: F401
    CorruptBlockError,
    DisqOptions,
    ErrorPolicy,
)

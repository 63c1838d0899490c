"""Host file layer: posix, in-memory and HTTP range-read wrappers,
byte-range splits, and the fault-injecting wrapper for tests."""

from disq_tpu_torch.fsw.faultfs import (  # noqa: F401
    FaultInjectingFileSystemWrapper,
    FaultSpec,
)
from disq_tpu_torch.fsw.filesystem import (  # noqa: F401
    FileSystemWrapper,
    MemoryFileSystemWrapper,
    PathSplit,
    PosixFileSystemWrapper,
    compute_path_splits,
    get_filesystem,
    register_filesystem,
    resolve_path,
)

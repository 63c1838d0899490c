"""flagstat — per-category read counts (the ``samtools flagstat``
equivalent) as torch ops over the flag column, on whatever device holds
it; only the 12 counts come back to the host."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

FLAGSTAT_FIELDS = (
    "total", "secondary", "supplementary", "duplicates", "mapped",
    "paired", "read1", "read2", "proper_pair", "with_mate_mapped",
    "singletons", "qc_fail",
)


def _counts(flag: torch.Tensor) -> torch.Tensor:
    """samtools-flagstat semantics: pair-related categories count only
    PRIMARY records (secondary 0x100 and supplementary 0x800 excluded),
    and 'with itself and mate mapped' requires the read itself mapped."""
    f = flag.to(torch.int32)

    def c(hit):
        return hit.sum()

    primary = (f & (0x100 | 0x800)) == 0
    paired = primary & ((f & 0x1) != 0)
    self_mapped = (f & 0x4) == 0
    mate_unmapped = (f & 0x8) != 0
    return torch.stack(
        [
            torch.tensor(f.numel(), device=f.device),
            c((f & 0x100) != 0),                         # secondary
            c((f & 0x800) != 0),                         # supplementary
            c((f & 0x400) != 0),                         # duplicates
            c(self_mapped),                              # mapped
            c(paired),                                   # paired
            c(paired & ((f & 0x40) != 0)),               # read1
            c(paired & ((f & 0x80) != 0)),               # read2
            c(paired & ((f & 0x2) != 0) & self_mapped),  # proper pair
            c(paired & self_mapped & ~mate_unmapped),    # with mate mapped
            c(paired & self_mapped & mate_unmapped),     # singletons
            c((f & 0x200) != 0),                         # qc fail
        ]
    )


def flagstat_counts(flag) -> Dict[str, int]:
    """Flag column (tensor on any device, or host array) → counts."""
    if isinstance(flag, np.ndarray):
        flag = torch.from_numpy(flag.astype(np.int32))
        row = _counts(flag).tolist()
    else:
        from disq_tpu_torch.runtime.tracing import device_span

        with device_span("device.kernel", kernel="flagstat",
                         records=flag.numel()) as fence:
            row = fence.sync(_counts(flag))
        row = row.cpu().tolist()
    if flag.is_cuda:
        from disq_tpu_torch.runtime import counters

        counters.book_transfer("d2h", 8 * len(row))
    return {k: int(v) for k, v in zip(FLAGSTAT_FIELDS, row)}

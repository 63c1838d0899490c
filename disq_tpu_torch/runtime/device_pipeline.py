"""Device-resident parse of a decoded shard.

``parse_columns_resident`` turns a decoded blob on the device plus the
host scan's record offsets into the fixed columns, in one launch of the
parse kernel (``ops/parse.py``), which reads the record prefixes in
place. The inflate kernel already wrote each block at its final offset
in one blob, so there is no assembly or padding step; offsets are int64
throughout, so a decoded shard of 2 GiB or more needs no special case.

``gather_record_words`` is the prefix gather as torch ops — the part of
the parse kernel's plain version that the kernel fuses away.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import device_span, span

N_WORDS = 9


def gather_record_words(blob: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The 9 little-endian words of each record's 36-byte prefix as
    ``(N, 9)`` int32, assembled from the bytes at ``starts[i] + 0..35``;
    bytes past the blob read as zero."""
    idx = starts[:, None] + torch.arange(4 * N_WORDS, device=blob.device)
    inside = idx < blob.numel()
    b = torch.where(inside, blob[idx.clamp(max=blob.numel() - 1)],
                    torch.zeros((), dtype=blob.dtype, device=blob.device))
    b = b.to(torch.int64).view(-1, N_WORDS, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    # the u32 value as int32 (two's complement wrap)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``, booking h2d bytes and a
    ``device.transfer`` span for a card. A read-only array (a view of
    staged ``bytes``) is wrapped without a copy: the tensor is only ever
    read — copied to the card, or read by a plain version on the CPU."""
    array = np.ascontiguousarray(array)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(array)
    if device.type != "cuda":
        return t.to(device)
    counters.book_transfer("h2d", t.numel() * t.element_size())
    with span("device.transfer", direction="h2d"):
        return t.to(device)


def parse_columns_resident(
    device_blob: torch.Tensor,
    offsets: np.ndarray,
    origin: int = 0,
) -> Dict[str, torch.Tensor]:
    """The 12 parse fields of the records at ``offsets`` as columns on
    ``device_blob``'s device. ``device_blob`` (the inflate kernel's
    output) is parsed in place, with ``origin`` rebasing the offsets
    into it."""
    from disq_tpu_torch.ops.parse import columns, parse_records

    starts = upload(np.asarray(offsets[:-1], dtype=np.int64) + origin,
                    device_blob.device)
    with device_span("device.kernel", kernel="columnar_parse",
                     records=len(offsets) - 1) as fence:
        return columns(fence.sync(parse_records(device_blob, starts)))

"""Decoded state carried across from the reference package.

This system has no model weights; what crosses between ``disq_tpu`` and
this port is data. These helpers take the reference's decoded state in
plain Python/numpy form — a record batch as numpy columns, a SAM header
as its text plus references, write options by name, read options and
error policies as any object with the reference's fields — and build the
port's objects from it, so both packages can be fed identical input and
configuration. Nothing here imports the reference.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, Sequence, Tuple

import numpy as np

from disq_tpu_torch.api import (
    BaiWriteOption,
    FileCardinalityWriteOption,
    ReadsDataset,
    ReadsFormatWriteOption,
    SbiWriteOption,
    WriteOption,
)
from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.bam.header import SamHeader, SamSequence
from disq_tpu_torch.runtime.errors import DisqOptions, ErrorPolicy

_DTYPES = {
    "refid": np.int32, "pos": np.int32, "mapq": np.uint8, "bin": np.uint16,
    "flag": np.uint16, "next_refid": np.int32, "next_pos": np.int32,
    "tlen": np.int32, "name_offsets": np.int64, "names": np.uint8,
    "cigar_offsets": np.int64, "cigars": np.uint32, "seq_offsets": np.int64,
    "seqs": np.uint8, "quals": np.uint8, "tag_offsets": np.int64,
    "tags": np.uint8,
}
_OPTIONS = {
    cls.__name__: cls for cls in (BaiWriteOption, SbiWriteOption,
                                  ReadsFormatWriteOption,
                                  FileCardinalityWriteOption)
}


def read_batch_from_columns(columns: Dict[str, np.ndarray]) -> ReadBatch:
    """A ``ReadBatch`` from the 17 ``ReadBatch`` columns by name (any
    object with those attributes works too). Dtypes must already be the
    record layout's; a mismatch raises rather than silently casting."""
    cols = {}
    for name, dt in _DTYPES.items():
        arr = np.asarray(columns[name] if isinstance(columns, dict)
                         else getattr(columns, name))
        if arr.dtype != dt:
            raise TypeError(f"column {name!r} is {arr.dtype}, want {np.dtype(dt)}")
        cols[name] = np.ascontiguousarray(arr)
    return ReadBatch(**cols)


def columns_of(batch) -> Dict[str, np.ndarray]:
    """The 17 columns of any ``ReadBatch``-shaped object as numpy."""
    return {name: np.asarray(getattr(batch, name)) for name in _DTYPES}


def header_from_text(text: str, refs: Sequence[Tuple[str, int]]) -> SamHeader:
    """A ``SamHeader`` from its text and its (name, length) references —
    the binary list is authoritative when the text carries no @SQ."""
    hdr = SamHeader.from_text(text)
    if not hdr.sequences and refs:
        hdr = SamHeader(text=text, sequences=tuple(
            SamSequence(n, int(ln)) for n, ln in refs))
    return hdr


def write_options(names: Sequence[str]) -> Tuple[WriteOption, ...]:
    """Write options by name, e.g. ``"BaiWriteOption.ENABLE"``."""
    out = []
    for name in names:
        cls_name, member = name.split(".", 1)
        out.append(_OPTIONS[cls_name][member])
    return tuple(out)


def dataset_from_state(header_text: str, refs: Sequence[Tuple[str, int]],
                       columns: Dict[str, np.ndarray]) -> ReadsDataset:
    """A ``ReadsDataset`` from a header (text + refs) and numpy columns."""
    return ReadsDataset(header=header_from_text(header_text, refs),
                        reads=read_batch_from_columns(columns))


def error_policy(policy) -> ErrorPolicy:
    """The port's ``ErrorPolicy`` for a policy enum of the reference (by
    its ``value``) or a name such as ``"skip"``."""
    return ErrorPolicy.coerce(getattr(policy, "value", policy))


def options_from(opts) -> DisqOptions:
    """The port's ``DisqOptions`` from any object (the reference's
    ``DisqOptions``) or dict with the same field names; fields the port
    has no counterpart for are left out."""
    get = opts.get if isinstance(opts, dict) else \
        (lambda name, default: getattr(opts, name, default))
    values = {f.name: get(f.name, f.default) for f in fields(DisqOptions)}
    values["error_policy"] = error_policy(values["error_policy"])
    return DisqOptions(**values)

"""Format dispatch — path extension / write option → source or sink.

BAM and CRAM are ported, each with single-file output and with a
directory of complete per-shard files
(``FileCardinalityWriteOption.MULTIPLE``); SAM raises.
"""

from __future__ import annotations

import enum
from typing import Optional

from disq_tpu_torch.api import FileCardinalityWriteOption, ReadsFormatWriteOption


class SamFormat(enum.Enum):
    BAM = ("bam", ".bam")
    CRAM = ("cram", ".cram")
    SAM = ("sam", ".sam")

    def __init__(self, key: str, extension: str):
        self.key = key
        self.extension = extension

    def _check_ported(self) -> None:
        if self is SamFormat.SAM:
            raise NotImplementedError(
                f"{self.key.upper()} is not ported to the PyTorch package yet")

    def make_source(self, storage):
        self._check_ported()
        if self is SamFormat.CRAM:
            from disq_tpu_torch.cram.source import CramSource

            return CramSource(storage)
        from disq_tpu_torch.bam.source import BamSource

        return BamSource(storage)

    def make_sink(self, storage, cardinality: FileCardinalityWriteOption):
        self._check_ported()
        single = cardinality is FileCardinalityWriteOption.SINGLE
        if self is SamFormat.CRAM:
            from disq_tpu_torch.cram.sink import CramSink, CramSinkMultiple

            return CramSink(storage) if single else CramSinkMultiple(storage)
        from disq_tpu_torch.bam.sink import BamSink, BamSinkMultiple

        return BamSink(storage) if single else BamSinkMultiple(storage)


def sam_format_from_path(path: str) -> SamFormat:
    lowered = path.lower()
    for fmt in SamFormat:
        if lowered.endswith(fmt.extension):
            return fmt
    raise ValueError(f"cannot infer reads format from path {path!r}")


def sam_format_from_write_options(
    path: str, fmt_opt: Optional[ReadsFormatWriteOption]
) -> SamFormat:
    if fmt_opt is not None:
        return SamFormat[fmt_opt.name]
    return sam_format_from_path(path)

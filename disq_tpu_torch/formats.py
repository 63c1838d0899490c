"""Format dispatch — path extension / write option → source or sink.

BAM and CRAM with single-file output are ported so far; SAM and
directory-of-parts output raise.
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
        if cardinality is not FileCardinalityWriteOption.SINGLE:
            raise NotImplementedError(
                "multi-file writes are not ported to the PyTorch package yet")
        if self is SamFormat.CRAM:
            from disq_tpu_torch.cram.sink import CramSink

            return CramSink(storage)
        from disq_tpu_torch.bam.sink import BamSink

        return BamSink(storage)


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

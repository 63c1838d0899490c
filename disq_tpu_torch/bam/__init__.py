"""BAM: header, columnar records, record codec and guesser."""

from disq_tpu_torch.bam.codec import (  # noqa: F401
    decode_records,
    encode_records,
    scan_record_offsets,
)
from disq_tpu_torch.bam.columnar import ReadBatch  # noqa: F401
from disq_tpu_torch.bam.guesser import BamRecordGuesser  # noqa: F401
from disq_tpu_torch.bam.header import SamHeader, SamSequence  # noqa: F401

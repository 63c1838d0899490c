"""SamSource — plain-text SAM read path.

Hadoop text line splits; ``@`` header lines skipped in each task; lines
parsed with the SAM line parser (``sam/text.py``). The header is read on
the host from the file's head. SAM is text with no BGZF, so no kernel
runs here: a read returns a host ``ReadBatch``, whose ``count``,
``flagstat`` and BAM write take the port's usual routes.
"""

from __future__ import annotations

from typing import List

from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.fsw.filesystem import (
    FileSystemWrapper,
    compute_path_splits,
    resolve_path,
)
from disq_tpu_torch.fsw.textsplit import lines_for_split
from disq_tpu_torch.sam.text import sam_lines_to_batch


def read_sam_header(fs: FileSystemWrapper, path: str) -> SamHeader:
    """Read the leading ``@`` lines (header) from a SAM file."""
    text_lines: List[str] = []
    pos = 0
    length = fs.get_file_length(path)
    CHUNK = 1 << 20
    pending = b""
    done = False
    while pos < length and not done:
        data = pending + fs.read_range(path, pos, min(CHUNK, length - pos))
        pos += len(data) - len(pending)
        lines = data.split(b"\n")
        pending = lines.pop()
        for ln in lines:
            if ln.startswith(b"@"):
                text_lines.append(ln.decode())
            else:
                done = True
                break
        if not done and pending and not pending.startswith(b"@") and pos >= length:
            break
    if not done and pending.startswith(b"@"):
        # the final header line of a file without a trailing newline
        text_lines.append(pending.decode())
    return SamHeader.from_text("\n".join(text_lines) + ("\n" if text_lines else ""))


class SamSource:
    def __init__(self, storage=None):
        self._storage = storage

    @property
    def split_size(self) -> int:
        return getattr(self._storage, "_split_size", 128 * 1024 * 1024)

    def get_reads(self, path: str, traversal=None):
        from disq_tpu_torch.api import ReadsDataset

        if traversal is not None:
            raise ValueError(
                "interval traversal requires an indexed format (BAM/CRAM); "
                "plain SAM has no index"
            )
        fs, path = resolve_path(path)
        header = read_sam_header(fs, path)
        batches = []
        for s in compute_path_splits(fs, path, self.split_size):
            lines = [
                ln.decode() for ln in lines_for_split(fs, path, s.start, s.end)
                if ln and not ln.startswith(b"@")
            ]
            batches.append(sam_lines_to_batch(lines, header))
        device = (self._storage._resolved_device()
                  if self._storage is not None else None)
        return ReadsDataset(header=header, reads=ReadBatch.concat(batches),
                            device=device)

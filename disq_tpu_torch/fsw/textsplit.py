"""Byte-range text splitting — Hadoop ``LineRecordReader`` semantics.

Reference parity: the reference reads text SAM and plain VCF through
Hadoop's ``TextInputFormat`` (SURVEY.md §2.6/§2.7): a split owns every
line that *starts* within its byte range; a reader starting mid-file
discards the partial first line (the previous split owns it) and reads
one line past its end to finish a straddling line.
"""

from __future__ import annotations

from typing import List

from disq_tpu_torch.fsw.filesystem import FileSystemWrapper

_CHUNK = 4 * 1024 * 1024


def lines_for_split(
    fs: FileSystemWrapper, path: str, start: int, end: int
) -> List[bytes]:
    """Complete lines (no trailing newline) whose first byte lies in
    ``[start, end)``."""
    length = fs.get_file_length(path)
    if start >= length:
        return []
    pos = start
    buf = b""
    if start > 0:
        # Discard the partial first line: scan to the first newline at or
        # after start-1 … the line after it is ours. Reading from start
        # and dropping through the first newline is equivalent unless the
        # byte at start-1 is itself a newline (then the line AT start is
        # ours) — handle by peeking one byte back.
        prev = fs.read_range(path, start - 1, 1)
        if prev != b"\n":
            buf = fs.read_range(path, pos, min(_CHUNK, length - pos))
            nl = buf.find(b"\n")
            while nl < 0:
                pos += len(buf)
                if pos >= length:
                    return []
                buf = fs.read_range(path, pos, min(_CHUNK, length - pos))
                nl = buf.find(b"\n")
            buf = buf[nl + 1:]
            pos += nl + 1

    lines: List[bytes] = []
    line_start = pos  # file offset of the next line's first byte
    carry = b""
    while True:
        if not buf:
            if pos >= length:
                break
            buf = fs.read_range(path, pos, min(_CHUNK, length - pos))
        consumed = 0
        while True:
            nl = buf.find(b"\n", consumed)
            if nl < 0:
                carry += buf[consumed:]
                pos += len(buf)
                buf = b""
                break
            line = carry + buf[consumed:nl]
            carry = b""
            if line_start >= end:
                return lines
            lines.append(line)
            line_start = pos + nl + 1
            consumed = nl + 1
        if line_start >= end and not carry:
            return lines
    if carry and line_start < end:
        lines.append(carry)  # final line without trailing newline
    return lines

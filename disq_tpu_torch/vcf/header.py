"""VCF header model + host-side header reading.

Replaces htsjdk's ``VCFHeader`` / ``VCFHeaderReader`` (used by the
reference's ``VcfSource``, SURVEY.md §2.7). The header is the ``##``
meta lines plus the ``#CHROM`` column line; contigs come from
``##contig=<ID=...,length=...>`` entries.
"""

from __future__ import annotations

import gzip
import io
import re
from dataclasses import dataclass, replace
from typing import BinaryIO, List, Optional, Tuple

from disq_tpu_torch.fsw.filesystem import FileSystemWrapper


@dataclass(frozen=True)
class VcfHeader:
    text: str  # all header lines incl. #CHROM line, newline-terminated
    contigs: Tuple[Tuple[str, Optional[int]], ...] = ()
    samples: Tuple[str, ...] = ()

    @property
    def contig_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.contigs)

    def contig_index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.contigs):
            if n == name:
                return i
        raise KeyError(f"contig {name!r} not in VCF header")

    @classmethod
    def from_text(cls, text: str) -> "VcfHeader":
        contigs: List[Tuple[str, Optional[int]]] = []
        samples: Tuple[str, ...] = ()
        for line in text.splitlines():
            if line.startswith("##contig="):
                m_id = re.search(r"[<,]ID=([^,>]+)", line)
                m_len = re.search(r"[<,]length=(\d+)", line)
                if m_id:
                    contigs.append(
                        (m_id.group(1), int(m_len.group(1)) if m_len else None)
                    )
            elif line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                if len(cols) > 9:
                    samples = tuple(cols[9:])
        return cls(text=text, contigs=tuple(contigs), samples=samples)

    def with_contigs(self, names: List[str]) -> "VcfHeader":
        """Append contigs (no length) that appear in data but not in the
        header — htsjdk-lenient behavior for headerless contigs."""
        known = set(self.contig_names)
        extra = [(n, None) for n in names if n not in known]
        if not extra:
            return self
        return replace(self, contigs=self.contigs + tuple(extra))


def sniff_compression(head: bytes) -> str:
    """'bgzf' | 'gzip' | 'plain' — the BGZFEnhancedGzipCodec sniff
    (SURVEY.md §2.3): a .gz that is really BGZF is splittable."""
    if len(head) >= 18 and head[:4] == b"\x1f\x8b\x08\x04":
        # check for BC extra subfield
        import struct

        xlen = struct.unpack_from("<H", head, 10)[0]
        p, end = 12, min(12 + xlen, len(head))
        while p + 4 <= end:
            if head[p] == 0x42 and head[p + 1] == 0x43:
                return "bgzf"
            slen = struct.unpack_from("<H", head, p + 2)[0]
            p += 4 + slen
    if head[:2] == b"\x1f\x8b":
        return "gzip"
    return "plain"


def open_decompressed(fs: FileSystemWrapper, path: str) -> BinaryIO:
    """A decompressed sequential stream regardless of compression."""
    head = fs.read_range(path, 0, 18)
    kind = sniff_compression(head)
    raw = fs.open(path)
    if kind == "bgzf":
        from disq_tpu_torch.bgzf.codec import BgzfReader

        return BgzfReader(raw)
    if kind == "gzip":
        return gzip.GzipFile(fileobj=raw)
    return raw


def read_vcf_header(fs: FileSystemWrapper, path: str) -> VcfHeader:
    """Host-side header read, before any split, for any compression."""
    stream = open_decompressed(fs, path)
    lines: List[str] = []
    buf = b""
    while True:
        # Modest chunks: reading far past the last header line would
        # needlessly decode body blocks — and turn a corrupt body block
        # (the error policy's job, per split) into a header failure.
        chunk = stream.read(4096)
        if not chunk:
            break
        buf += chunk
        done = False
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            line = buf[:nl]
            buf = buf[nl + 1:]
            if line.startswith(b"#"):
                lines.append(line.decode())
                if line.startswith(b"#CHROM"):
                    done = True
                    break
            else:
                done = True
                break
        if done:
            break
    return VcfHeader.from_text("\n".join(lines) + ("\n" if lines else ""))

"""SAM/BAM header model.

Replaces htsjdk's ``SAMFileHeader`` + ``SAMSequenceDictionary`` for this
framework. The header is host-side metadata: in the sharded pipeline it is
broadcast (replicated) to all devices' host workers, the analogue of
disq's Spark broadcast of the header (SURVEY.md §3.1).

Binary BAM header layout (SAM spec §4.2): magic ``BAM\\1``, ``l_text``,
header text, ``n_ref``, then per reference ``l_name`` (incl. NUL), name,
``l_ref``.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field, replace
from typing import BinaryIO, List, Tuple

BAM_MAGIC = b"BAM\x01"


@dataclass(frozen=True)
class SamSequence:
    """One @SQ entry / binary reference entry."""

    name: str
    length: int


@dataclass(frozen=True)
class SamHeader:
    """Immutable SAM header: raw text + parsed sequence dictionary.

    The text is authoritative (round-trips byte-identically); the
    sequence list is the parsed view used by decode/sort/index layers.
    """

    text: str
    sequences: Tuple[SamSequence, ...] = ()

    @property
    def n_ref(self) -> int:
        return len(self.sequences)

    @property
    def sort_order(self) -> str:
        m = re.search(r"^@HD\t.*\bSO:(\S+)", self.text, re.MULTILINE)
        return m.group(1) if m else "unknown"

    def with_sort_order(self, so: str) -> "SamHeader":
        if re.search(r"^@HD\t", self.text, re.MULTILINE):
            if re.search(r"^@HD\t.*\bSO:\S+", self.text, re.MULTILINE):
                text = re.sub(
                    r"(^@HD\t.*\bSO:)\S+", lambda m: m.group(1) + so,
                    self.text, count=1, flags=re.MULTILINE,
                )
            else:
                text = re.sub(
                    r"^(@HD\t[^\n]*)", lambda m: m.group(1) + f"\tSO:{so}",
                    self.text, count=1, flags=re.MULTILINE,
                )
        else:
            text = f"@HD\tVN:1.6\tSO:{so}\n" + self.text
        return replace(self, text=text)

    def ref_index(self, name: str) -> int:
        for i, s in enumerate(self.sequences):
            if s.name == name:
                return i
        raise KeyError(f"reference {name!r} not in sequence dictionary")

    def ref_name(self, index: int) -> str:
        if index == -1:
            return "*"
        return self.sequences[index].name

    # -- construction -------------------------------------------------------

    @classmethod
    def from_text(cls, text: str) -> "SamHeader":
        seqs = []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:] if ":" in f
                )
                seqs.append(SamSequence(fields["SN"], int(fields["LN"])))
        return cls(text=text, sequences=tuple(seqs))

    @classmethod
    def build(cls, sequences: List[Tuple[str, int]], sort_order: str = "unsorted") -> "SamHeader":
        lines = [f"@HD\tVN:1.6\tSO:{sort_order}"]
        lines += [f"@SQ\tSN:{n}\tLN:{l}" for n, l in sequences]
        return cls.from_text("\n".join(lines) + "\n")

    # -- binary BAM header --------------------------------------------------

    def to_bam_bytes(self) -> bytes:
        """Serialize as the binary BAM header block (magic..refs)."""
        text_b = self.text.encode()
        out = bytearray()
        out += BAM_MAGIC
        out += struct.pack("<i", len(text_b))
        out += text_b
        out += struct.pack("<i", len(self.sequences))
        for s in self.sequences:
            name_b = s.name.encode() + b"\x00"
            out += struct.pack("<i", len(name_b))
            out += name_b
            out += struct.pack("<i", s.length)
        return bytes(out)

    @classmethod
    def from_bam_stream(cls, stream) -> "SamHeader":
        """Parse the binary BAM header from a decompressed stream
        (``BgzfReader`` or any object with ``read_exact``/``read``)."""
        read = getattr(stream, "read_exact", None) or (
            lambda n: _read_exact(stream, n)
        )
        magic = read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"not a BAM stream (magic {magic!r})")
        (l_text,) = struct.unpack("<i", read(4))
        text = read(l_text).decode(errors="replace")
        # Some writers NUL-pad the text field.
        text = text.rstrip("\x00")
        (n_ref,) = struct.unpack("<i", read(4))
        seqs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", read(4))
            name = read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", read(4))
            seqs.append(SamSequence(name, l_ref))
        binary_seqs = tuple(seqs)
        hdr = cls.from_text(text)
        # The binary sequence list is authoritative when the text lacks @SQ.
        if not hdr.sequences and binary_seqs:
            hdr = replace(hdr, sequences=binary_seqs)
        return hdr


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    data = b""
    while len(data) < n:
        chunk = stream.read(n - len(data))
        if not chunk:
            raise EOFError("truncated BAM header")
        data += chunk
    return data

"""CRAM reference source — FASTA + .fai access.

Reference parity: htsjdk ``ReferenceSource`` built by disq's
``CramReferenceSourceBuilder`` from ``referenceSourcePath`` (SURVEY.md
§2.5): reading reference-compressed CRAM REQUIRES the reference; lookups
are cached per contig. Works over any ``FileSystemWrapper``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from disq_tpu_torch.fsw.filesystem import FileSystemWrapper, resolve_path


class CramReferenceSource:
    def __init__(self, fs: FileSystemWrapper, path: str):
        self.fs = fs
        self.path = path
        self._fai = self._load_fai()
        self._cache: Dict[str, bytes] = {}
        # one load of a contig, whichever split's worker asks first
        self._load_lock = threading.Lock()
        self._names: List[str] = list(self._fai)

    def _load_fai(self) -> Dict[str, Tuple[int, int, int, int]]:
        fai_path = self.path + ".fai"
        if self.fs.exists(fai_path):
            out = {}
            for line in self.fs.read_all(fai_path).decode().splitlines():
                if not line.strip():
                    continue
                name, length, offset, linebases, linewidth = line.split("\t")[:5]
                out[name] = (int(length), int(offset), int(linebases), int(linewidth))
            return out
        return self._index_fasta()

    def _index_fasta(self) -> Dict[str, Tuple[int, int, int, int]]:
        """Build an in-memory .fai when none exists (small references)."""
        data = self.fs.read_all(self.path)
        out: Dict[str, Tuple[int, int, int, int]] = {}
        pos = 0
        name = None
        seq_start = 0
        linebases = linewidth = 0
        length = 0
        for line in data.split(b"\n"):
            ll = len(line) + 1
            if line.startswith(b">"):
                if name is not None:
                    out[name] = (length, seq_start, linebases, linewidth)
                name = line[1:].split()[0].decode()
                seq_start = pos + ll
                length = 0
                linebases = linewidth = 0
            elif line and name is not None:
                if linebases == 0:
                    linebases, linewidth = len(line), ll
                length += len(line)
            pos += ll
        if name is not None:
            out[name] = (length, seq_start, linebases, linewidth)
        return out

    def contig_length(self, name: str) -> int:
        return self._fai[name][0]

    def bases_by_name(self, name: str, start0: int, length: int) -> bytes:
        """Uppercase reference bases [start0, start0+length)."""
        seq = self._cache.get(name)
        if seq is None:
            total, offset, linebases, linewidth = self._fai[name]
            if linebases <= 0:
                return b""
            with self._load_lock:
                seq = self._cache.get(name)
                if seq is None:
                    n_lines = -(-total // linebases)
                    raw = self.fs.read_range(
                        self.path, offset, n_lines * linewidth
                    )
                    seq = raw.replace(b"\n", b"").replace(
                        b"\r", b"")[:total].upper()
                    self._cache[name] = seq
        return seq[start0: start0 + length]

    def fetcher(self, contig_names: List[str]):
        """→ ``ref_fetch(refid, start0, length) -> bytes | None`` resolving
        refids through the SAM header's sequence dictionary order."""

        def fetch(refid: int, start0: int, length: int) -> Optional[bytes]:
            if refid < 0 or refid >= len(contig_names):
                return None
            name = contig_names[refid]
            if name not in self._fai:
                return None
            return self.bases_by_name(name, start0, length)

        return fetch


def write_fasta(
    fs: FileSystemWrapper, path: str, contigs: List[Tuple[str, bytes]],
    line_width: int = 60,
) -> None:
    """Utility: write a FASTA + .fai pair (used by tests/benchmarks)."""
    out = bytearray()
    fai_lines = []
    for name, seq in contigs:
        out += b">" + name.encode() + b"\n"
        offset = len(out)
        for i in range(0, len(seq), line_width):
            out += seq[i: i + line_width] + b"\n"
        fai_lines.append(
            f"{name}\t{len(seq)}\t{offset}\t{line_width}\t{line_width + 1}"
        )
    fs.write_all(path, bytes(out))
    fs.write_all(path + ".fai", ("\n".join(fai_lines) + "\n").encode())


def fetcher_for_storage(storage, header):
    """Resolve ``storage.reference_source_path`` → a refid-keyed fetcher
    (shared by the CRAM read and write paths), or None when unset."""
    path = getattr(storage, "_reference_source_path", None)
    if not path:
        return None
    fs, path = resolve_path(path)
    src = CramReferenceSource(fs, path)
    return src.fetcher([s.name for s in header.sequences])

"""Host file layer: posix and in-memory wrappers plus byte-range splits.

Counterpart of ``disq_tpu/fsw/filesystem.py`` restricted to local
paths; remote schemes (``http(s)://``, ``gs://``, ``s3://``) come in a
later slice and raise here.
"""

from __future__ import annotations

import io
import os
import shutil
import uuid
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class PathSplit:
    """A byte-range split ``[start, end)`` of a file."""

    path: str
    start: int
    end: int

    @property
    def length(self) -> int:
        return self.end - self.start


DEFAULT_SPLIT_SIZE = 128 * 1024 * 1024


class FileSystemWrapper:
    """Uniform file ops used by every layer above."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def get_file_length(self, path: str) -> int:
        raise NotImplementedError

    def open(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def create(self, path: str) -> BinaryIO:
        raise NotImplementedError

    def read_range(self, path: str, start: int, length: int) -> bytes:
        with self.open(path) as f:
            f.seek(start)
            return f.read(length)

    def read_all(self, path: str) -> bytes:
        return self.read_range(path, 0, self.get_file_length(path))

    def write_all(self, path: str, data: bytes) -> None:
        with self.create(path) as f:
            f.write(data)

    def list_directory(self, path: str) -> List[str]:
        raise NotImplementedError

    def concat(self, parts: Sequence[str], target: str) -> None:
        """Concatenate ``parts`` into ``target`` (stream copy)."""
        with self.create(target) as out:
            for part in parts:
                with self.open(part) as f:
                    shutil.copyfileobj(f, out, 8 * 1024 * 1024)

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError


class _AtomicWriteFile(io.FileIO):
    """Write stream staged to a hidden sibling and published with
    ``os.replace`` on close; leaving a ``with`` block on an exception
    (or garbage collection without close) discards it instead, so a
    killed writer never leaves a truncated file at the final path."""

    def __init__(self, tmp_path: str, final_path: str) -> None:
        super().__init__(tmp_path, "w")
        self._tmp_path = tmp_path
        self._final_path = final_path
        self._aborted = False

    def write(self, b) -> int:
        # FileIO.write is one os.write and may be short: loop
        mv = memoryview(b).cast("B")
        done = 0
        while done < len(mv):
            n = super().write(mv[done:])
            if not n:
                raise IOError(
                    f"short write to {self._tmp_path!r} at byte {done}")
            done += n
        return done

    def __exit__(self, exc_type, exc, tb) -> None:
        self._aborted = self._aborted or exc_type is not None
        super().__exit__(exc_type, exc, tb)

    def __del__(self) -> None:
        self._aborted = True
        super().__del__()

    def close(self) -> None:
        if self.closed:
            return
        super().close()
        if self._aborted:
            try:
                os.unlink(self._tmp_path)
            except (FileNotFoundError, TypeError):
                pass
        else:
            os.replace(self._tmp_path, self._final_path)


class PosixFileSystemWrapper(FileSystemWrapper):
    """Local filesystem."""

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def get_file_length(self, path: str) -> int:
        return os.path.getsize(path)

    def open(self, path: str) -> BinaryIO:
        return open(path, "rb")

    def create(self, path: str) -> BinaryIO:
        path = os.path.abspath(path)
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(
            parent,
            f".{os.path.basename(path)}.tmp-{os.getpid()}-"
            f"{uuid.uuid4().hex[:8]}",
        )
        return _AtomicWriteFile(tmp, path)

    def list_directory(self, path: str) -> List[str]:
        return sorted(
            os.path.join(path, name)
            for name in os.listdir(path)
            if not name.startswith(".") and not name.startswith("_")
        )

    def delete(self, path: str, recursive: bool = False) -> None:
        if os.path.isdir(path):
            if recursive:
                shutil.rmtree(path)
            else:
                os.rmdir(path)
        elif os.path.exists(path):
            os.remove(path)

    def mkdirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


class MemoryFileSystemWrapper(FileSystemWrapper):
    """In-memory filesystem for tests."""

    def __init__(self) -> None:
        self._files: Dict[str, bytes] = {}

    def exists(self, path: str) -> bool:
        prefix = path.rstrip("/") + "/"
        return path in self._files or any(
            p.startswith(prefix) for p in self._files)

    def get_file_length(self, path: str) -> int:
        return len(self._files[path])

    def open(self, path: str) -> BinaryIO:
        return io.BytesIO(self._files[path])

    def create(self, path: str) -> BinaryIO:
        fs = self

        class _Writer(io.BytesIO):
            def close(self) -> None:
                fs._files[path] = self.getvalue()
                super().close()

        return _Writer()

    def list_directory(self, path: str) -> List[str]:
        prefix = path.rstrip("/") + "/"
        names = [p for p in self._files
                 if p.startswith(prefix) and "/" not in p[len(prefix):]]
        return sorted(n for n in names
                      if not os.path.basename(n).startswith((".", "_")))

    def delete(self, path: str, recursive: bool = False) -> None:
        if path in self._files:
            del self._files[path]
        elif recursive:
            prefix = path.rstrip("/") + "/"
            for p in [p for p in self._files if p.startswith(prefix)]:
                del self._files[p]

    def mkdirs(self, path: str) -> None:
        pass


_POSIX = PosixFileSystemWrapper()
_SCHEME_REGISTRY: Dict[str, FileSystemWrapper] = {}


def register_filesystem(scheme: str, fs: FileSystemWrapper) -> None:
    """Install a wrapper for ``scheme`` (e.g. ``mem`` in tests)."""
    _SCHEME_REGISTRY[scheme] = fs


def resolve_path(path: str) -> Tuple[FileSystemWrapper, str]:
    """Scheme dispatch: URI → (wrapper, normalized path)."""
    scheme = path.split("://", 1)[0] if "://" in path else ""
    if scheme in _SCHEME_REGISTRY:
        return _SCHEME_REGISTRY[scheme], path
    if path.startswith("file://"):
        return _POSIX, path[len("file://"):]
    if scheme:
        raise ValueError(
            f"scheme {scheme!r} is not supported by the PyTorch port yet")
    return _POSIX, path


def compute_path_splits(
    fs: FileSystemWrapper, path: str, split_size: int = DEFAULT_SPLIT_SIZE
) -> List[PathSplit]:
    """File → byte-range splits tiling ``[0, length)``; the records a
    split owns are refined by the format layer (first-owner rule)."""
    if split_size <= 0:
        raise ValueError(f"split_size must be positive, got {split_size}")
    length = fs.get_file_length(path)
    if length == 0:
        return []
    return [
        PathSplit(path, start, min(start + split_size, length))
        for start in range(0, length, split_size)
    ]

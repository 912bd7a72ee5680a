"""Little-endian binary format helpers.

Same framing discipline as the reference's io.WriterTo/ReaderFrom formats
(4-byte magic + u32 version header, then typed payload — e.g.
flat_index.go:343-403), with numpy arrays written as dtype-tagged blocks.
Magic values are distinct from the reference's (this is a new format).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO

import numpy as np

from comet_tpu_torch.types import CometError


class SerializationError(CometError):
    pass


class CrcWriter:
    """Write-through wrapper keeping a running CRC32 of every byte written.

    Index payloads are sealed with a 4-byte CRC32 trailer (covering magic,
    version, and payload) so that *any* byte flip is detected at load time —
    the reference's formats have no integrity check at all and will happily
    half-load corrupt blobs. Call seal() after the last payload byte."""

    def __init__(self, f: BinaryIO):
        self._f = f
        self._crc = 0

    def write(self, data: bytes) -> int:
        self._crc = zlib.crc32(data, self._crc)
        return self._f.write(data)

    def seal(self) -> None:
        """Append the CRC32 trailer to the underlying stream (not counted)."""
        self._f.write(struct.pack("<I", self._crc))


class CrcReader:
    """Read-through wrapper keeping a running CRC32 of every byte consumed.

    After parsing a payload written through CrcWriter, call verify(): it
    reads the 4-byte trailer from the underlying stream and raises
    SerializationError when the payload was altered in transit/storage.
    Leaves any bytes after the trailer unconsumed (formats stay
    length-delimited, not EOF-delimited)."""

    def __init__(self, f: BinaryIO):
        self._f = f
        self._crc = 0

    def read(self, n: int = -1) -> bytes:
        data = self._f.read(n)
        self._crc = zlib.crc32(data, self._crc)
        return data

    def verify(self) -> None:
        trailer = self._f.read(4)
        if len(trailer) != 4:
            raise SerializationError("unexpected EOF: missing checksum trailer")
        (want,) = struct.unpack("<I", trailer)
        if want != self._crc:
            raise SerializationError(
                f"payload checksum mismatch: stored={want:#010x}, "
                f"computed={self._crc:#010x}"
            )


_DTYPES = {
    "f4": np.float32,
    "f8": np.float64,
    "u4": np.uint32,
    "u8": np.uint64,
    "i4": np.int32,
    "i8": np.int64,
    "u1": np.uint8,
    "b1": np.bool_,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def write_magic(f: BinaryIO, magic: bytes, version: int) -> None:
    assert len(magic) == 4
    f.write(magic)
    f.write(struct.pack("<I", version))


def read_magic(f: BinaryIO, magic: bytes, max_version: int = 1) -> int:
    got = f.read(4)
    if got != magic:
        raise SerializationError(f"bad magic: expected {magic!r}, got {got!r}")
    (version,) = struct.unpack("<I", _read_exact(f, 4))
    if not 1 <= version <= max_version:
        raise SerializationError(f"unsupported version {version} for {magic!r}")
    return version


def _read_exact(f: BinaryIO, n: int) -> bytes:
    try:
        data = f.read(n)
    except (OverflowError, MemoryError) as e:
        # corrupt length fields can demand absurd reads; surface them as
        # payload corruption, not as interpreter errors
        raise SerializationError(f"implausible field length {n}") from e
    if len(data) != n:
        raise SerializationError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
    return data


def write_u32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<I", v))


def read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", _read_exact(f, 4))[0]


def write_u64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<Q", v))


def read_u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(f, 8))[0]


def write_i64(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<q", v))


def read_i64(f: BinaryIO) -> int:
    return struct.unpack("<q", _read_exact(f, 8))[0]


def write_str(f: BinaryIO, s: str) -> None:
    raw = s.encode("utf-8")
    f.write(struct.pack("<I", len(raw)))
    f.write(raw)


def read_str(f: BinaryIO) -> str:
    n = read_u32(f)
    return _read_exact(f, n).decode("utf-8")


def write_array(f: BinaryIO, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise SerializationError(f"unsupported dtype {arr.dtype}")
    f.write(code.encode("ascii"))
    f.write(struct.pack("<B", arr.ndim))
    for s in arr.shape:
        write_u64(f, s)
    f.write(arr.tobytes())


def read_array(f: BinaryIO) -> np.ndarray:
    code = _read_exact(f, 2).decode("ascii")
    if code not in _DTYPES:
        raise SerializationError(f"unknown dtype code {code!r}")
    dtype = np.dtype(_DTYPES[code])
    (ndim,) = struct.unpack("<B", _read_exact(f, 1))
    shape = tuple(read_u64(f) for _ in range(ndim))
    nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
    if ndim == 0:
        return np.frombuffer(_read_exact(f, nbytes), dtype=dtype)[0]
    count = int(np.prod(shape))
    raw = _read_exact(f, dtype.itemsize * count)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

"""Version blobs as ``.npz`` containers that store what does not shrink.

The plain checkpoint path (no ``DeltaCheckpointCodec``) writes the state's
leaves as the members ``arr_0.npy``, ``arr_1.npy``, ... of a zip archive, the
layout of ``np.savez``, so ``np.load`` reads a blob and the reference's
``TrainerStateObject.Restore`` restores it. How each member is encoded is
read from the leaf's bits:

* a leaf with a non-zero bit is copied to the host and **stored**: its CRC-32
  is taken, nothing is deflated (f32 weights and moments do not shrink);
* an all-zero leaf is never copied from the device. Its member, the ``.npy``
  header and zeros, is **deflated** at level 1, from one deflated chunk of
  zeros repeated (each copy starts after a full flush, so the stream is an
  ordinary deflate stream), and its CRC-32 is extended over the zeros
  arithmetically. Leaves with one shape and dtype have byte-identical
  members: one is made, the others reuse its bytes.

``zipfile`` cannot take a member that was deflated elsewhere, so ``pack``
writes the container itself: local headers, data, central directory, with
zip64 fields where a size or offset needs them, a fixed timestamp (the bytes
depend on the state alone), and each stored member's data 64-byte aligned
from the container's start (an alignment field in its local header).

``Reader`` parses the central directory once over a ``memoryview``. A stored
member is read in place, its CRC checked; a deflated one is inflated and
checked, once for all byte-identical compressed members; any other method
goes through ``np.load``. It reads ``np.savez_compressed`` archives too.
"""
from __future__ import annotations

import collections
import functools
import io
import struct
import warnings
import zipfile
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from numpy.lib import format as npy

#: sizes and offsets above this take zip64 fields (``zipfile``'s limit)
ZIP64_LIMIT = (1 << 31) - 1
_COUNT_LIMIT = (1 << 16) - 1
_ALIGN = 64
_ZERO_CHUNK = 1 << 20
_LEVEL = 1

_LOCAL = struct.Struct("<4s5H3L2H")           # signature .. extra length
_CENTRAL = struct.Struct("<4s6H3L5H2L")       # signature .. local header offset
_END = struct.Struct("<4s4H2LH")
_END64 = struct.Struct("<4sQ2H2L4Q")
_LOCATOR64 = struct.Struct("<4sLQL")
_SIG_LOCAL, _SIG_CENTRAL = b"PK\x03\x04", b"PK\x01\x02"
_SIG_END, _SIG_END64, _SIG_LOCATOR64 = b"PK\x05\x06", b"PK\x06\x06", b"PK\x06\x07"
_DOS_DATE = (1 << 5) | 1                      # 1980-01-01 00:00:00
_ALIGN_FIELD = 0xD935                         # the alignment extra field of zipalign
_STORED, _DEFLATED = zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED

Buffer = Union[bytes, memoryview]


class Zero(NamedTuple):
    """An all-zero leaf, left on the device."""
    shape: Tuple[int, ...]
    dtype: np.dtype


class Packed(NamedTuple):
    parts: List[Buffer]   # the archive, in order; ``b"".join`` them
    stored: int           # members stored
    deflated: int         # members deflated
    reused: int           # deflated members that reused another's bytes


# -- the leaves --------------------------------------------------------------
def to_host(leaves: Sequence[torch.Tensor]) -> List[Union[np.ndarray, Zero]]:
    """Each leaf as a C-ordered host array, or as ``Zero`` when every bit of
    it is 0. Whether each leaf is zero is read in one batched reduction (one
    read from the device); only the other leaves are copied."""
    if not leaves:
        return []
    nonzero = torch.stack([l.detach().reshape(-1).view(torch.uint8).any()
                           for l in leaves]).tolist()
    return [l.detach().contiguous().cpu().numpy() if nz
            else Zero(tuple(l.shape), torch.empty(0, dtype=l.dtype).numpy().dtype)
            for l, nz in zip(leaves, nonzero)]


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``. ``a`` may be a read-only view of a blob:
    it is only read, so torch's warning about such arrays is not raised."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


# -- writing -----------------------------------------------------------------
def _npy_header(shape: Tuple[int, ...], dtype: np.dtype) -> bytes:
    """The ``.npy`` header ``np.save`` writes for a C-ordered array."""
    buf = io.BytesIO()
    npy.write_array_header_1_0(buf, {"descr": npy.dtype_to_descr(dtype), "fortran_order": False,
                                     "shape": tuple(shape)})
    return buf.getvalue()


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, m) for m in mat]


def crc32_zeros(crc: int, n: int) -> int:
    """``zlib.crc32(bytes(n), crc)`` in O(log n): appending a zero byte is a
    linear map of the CRC register, raised to the n-th power by squaring."""
    op = [0xEDB88320] + [1 << i for i in range(31)]   # one zero bit
    for _ in range(3):
        op = _gf2_square(op)                         # one zero byte
    reg = crc ^ 0xFFFFFFFF
    while n:
        if n & 1:
            reg = _gf2_times(op, reg)
        n >>= 1
        if n:
            op = _gf2_square(op)
    return reg ^ 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _zero_block() -> bytes:
    """``_ZERO_CHUNK`` zeros deflated by a fresh compressor, then fully
    flushed: the block refers to nothing before it, so copies of it follow
    any full flush of a stream."""
    c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15)
    return c.compress(bytes(_ZERO_CHUNK)) + c.flush(zlib.Z_FULL_FLUSH)


def _deflate_zeros(header: bytes, nbytes: int) -> bytes:
    """Raw deflate of ``header`` and ``nbytes`` zeros."""
    q, r = divmod(nbytes, _ZERO_CHUNK)
    c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15)
    return b"".join([c.compress(header), c.flush(zlib.Z_FULL_FLUSH), _zero_block() * q,
                     c.compress(bytes(r)), c.flush()])


def pack(members: Sequence[Union[np.ndarray, Zero]]) -> Packed:
    """The archive of ``members`` (``to_host``'s list), in order."""
    parts: List[Buffer] = []
    central: List[bytes] = []
    zero_members: Dict[bytes, Tuple[bytes, int, int]] = {}   # header -> data, crc, size
    pos = stored = reused = 0
    for i, m in enumerate(members):
        name = f"arr_{i}.npy".encode()
        header = _npy_header(m.shape, m.dtype)
        if isinstance(m, Zero):
            if header in zero_members:
                reused += 1
            else:
                n = int(np.prod(m.shape, dtype=np.int64)) * m.dtype.itemsize
                zero_members[header] = (_deflate_zeros(header, n),
                                        crc32_zeros(zlib.crc32(header), n), len(header) + n)
            data, crc, usize = zero_members[header]
            method, body = _DEFLATED, [data]
            csize = len(data)
        else:
            view = memoryview(m.reshape(-1).view(np.uint8))
            method, body = _STORED, [header, view]
            csize = usize = len(header) + m.nbytes
            crc = zlib.crc32(view, zlib.crc32(header))
            stored += 1
        big = csize > ZIP64_LIMIT or usize > ZIP64_LIMIT
        extra = struct.pack("<2H2Q", 1, 16, usize, csize) if big else b""
        if method == _STORED:   # align the data from the archive's start
            pad = -(pos + _LOCAL.size + len(name) + len(extra)) % _ALIGN
            if pad:
                pad += _ALIGN if pad < 6 else 0
                extra += struct.pack("<3H", _ALIGN_FIELD, pad - 4, _ALIGN) + bytes(pad - 6)
        version = 45 if big else 20
        size32 = 0xFFFFFFFF if big else None
        parts.append(_LOCAL.pack(_SIG_LOCAL, version, 0, method, 0, _DOS_DATE, crc,
                                 size32 or csize, size32 or usize, len(name), len(extra)))
        parts += [name, extra, *body]
        central.append(_central(name, method, crc, csize, usize, pos))
        pos += _LOCAL.size + len(name) + len(extra) + csize
    parts += central
    parts.append(_end(len(members), sum(map(len, central)), pos))
    return Packed(parts, stored, len(members) - stored, reused)


def _central(name: bytes, method: int, crc: int, csize: int, usize: int, offset: int) -> bytes:
    z64, fields = [], []
    for v in (usize, csize, offset):   # the zip64 field's order
        if v > ZIP64_LIMIT:
            z64.append(v)
            fields.append(0xFFFFFFFF)
        else:
            fields.append(v)
    extra = struct.pack(f"<2H{len(z64)}Q", 1, 8 * len(z64), *z64) if z64 else b""
    version = 45 if z64 else 20
    usize32, csize32, offset32 = fields
    return _CENTRAL.pack(_SIG_CENTRAL, (3 << 8) | version, version, 0, method, 0, _DOS_DATE,
                         crc, csize32, usize32, len(name), len(extra), 0, 0, 0, 0o600 << 16,
                         offset32) + name + extra


def _end(count: int, size: int, offset: int) -> bytes:
    out = b""
    if count > _COUNT_LIMIT or size > ZIP64_LIMIT or offset > ZIP64_LIMIT:
        out = _END64.pack(_SIG_END64, _END64.size - 12, 45, 45, 0, 0, count, count, size, offset)
        out += _LOCATOR64.pack(_SIG_LOCATOR64, 0, offset + size, 1)
        count, size, offset = min(count, 0xFFFF), min(size, 0xFFFFFFFF), min(offset, 0xFFFFFFFF)
    return out + _END.pack(_SIG_END, 0, 0, count, count, size, offset, 0)


# -- reading -----------------------------------------------------------------
class _Member(NamedTuple):
    name: str
    method: int
    crc: int
    csize: int
    usize: int
    offset: int   # of the local header


class Reader:
    """The members of an ``.npz`` archive in ``buf``, in directory order.

    ``array(i)`` returns member i: a read-only view of ``buf`` where it is
    stored and aligned, a view of its inflated bytes where it is deflated.
    ``reused`` counts the deflated members whose bytes were inflated for an
    earlier, byte-identical one."""

    def __init__(self, buf: Buffer) -> None:
        self._buf = memoryview(buf).cast("B")
        self.members = _directory(self._buf)
        self.reused = 0
        self._npz: Optional[np.lib.npyio.NpzFile] = None
        # an inflated member is kept while a later one may have its bytes
        self._left = collections.Counter((m.crc, m.csize, m.usize) for m in self.members
                                         if m.method == _DEFLATED)
        self._inflated: Dict[Tuple[int, int, int], Tuple[memoryview, bytes]] = {}

    def __len__(self) -> int:
        return len(self.members)

    def array(self, i: int) -> np.ndarray:
        m = self.members[i]
        if m.method == _STORED:
            data = self._data(m)
            _check_crc(m, zlib.crc32(data))
            return _array(data, m.name)
        if m.method == _DEFLATED:
            return _array(self._inflate(m), m.name)
        if self._npz is None:
            self._npz = np.load(io.BytesIO(self._buf))
        return self._npz[m.name[:-4] if m.name.endswith(".npy") else m.name]

    def _data(self, m: _Member) -> memoryview:
        head = self._buf[m.offset : m.offset + _LOCAL.size]
        if len(head) < _LOCAL.size:
            raise zipfile.BadZipFile(f"{m.name}: local header out of range")
        sig, _, flags, *_, n_name, n_extra = _LOCAL.unpack(head)
        start = m.offset + _LOCAL.size
        if sig != _SIG_LOCAL or bytes(self._buf[start : start + n_name]) != m.name.encode():
            raise zipfile.BadZipFile(f"{m.name}: bad local header")
        if flags & 1:
            raise zipfile.BadZipFile(f"{m.name}: encrypted")
        start += n_name + n_extra
        if start + m.csize > len(self._buf):
            raise zipfile.BadZipFile(f"{m.name}: data out of range")
        return self._buf[start : start + m.csize]

    def _inflate(self, m: _Member) -> bytes:
        key = (m.crc, m.csize, m.usize)
        data = self._data(m)
        hit = self._inflated.get(key)
        if hit is not None and hit[0] == data:
            self.reused += 1
            out = hit[1]
        else:
            try:
                out = zlib.decompress(data, -15, max(m.usize, 1))
            except zlib.error as e:
                raise zipfile.BadZipFile(f"{m.name}: {e}") from None
            if len(out) != m.usize:
                raise zipfile.BadZipFile(f"{m.name}: {len(out)} bytes inflated, {m.usize} listed")
            _check_crc(m, zlib.crc32(out))
            if hit is None:
                self._inflated[key] = (data, out)
        self._left[key] -= 1
        if not self._left[key]:
            self._inflated.pop(key, None)
        return out


def _check_crc(m: _Member, crc: int) -> None:
    if crc != m.crc:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {m.name!r}")


def _array(data: Buffer, name: str) -> np.ndarray:
    """The array of one ``.npy`` member's bytes, viewed in place where its
    data is aligned for its dtype."""
    data = memoryview(data)
    if len(data) < 10:
        raise ValueError(f"{name}: not a .npy member")
    major = data[6]
    if major == 1:
        start = 10 + int.from_bytes(data[8:10], "little")
    elif major == 2:
        start = 12 + int.from_bytes(data[8:12], "little")
    else:
        raise ValueError(f"{name}: .npy version {major} is not read here")
    head = io.BytesIO(data[:start])
    version = npy.read_magic(head)
    read = npy.read_array_header_1_0 if version == (1, 0) else npy.read_array_header_2_0
    shape, fortran, dtype = read(head)
    if dtype.hasobject:
        raise ValueError(f"{name}: object arrays are not read")
    count = int(np.prod(shape, dtype=np.int64))
    if start + count * dtype.itemsize != len(data):
        raise ValueError(f"{name}: {len(data) - start} data bytes for shape {shape} of {dtype}")
    a = np.frombuffer(data, dtype, count, start)
    if fortran:
        return a.reshape(shape[::-1]).T.copy()
    a = a.reshape(shape)
    return a if a.flags.aligned else a.copy()


def _directory(buf: memoryview) -> List[_Member]:
    """The central directory's entries (the end record found from the back,
    zip64 records and fields read where present)."""
    at = bytes(buf[-(_END.size + 0xFFFF):]).rfind(_SIG_END)
    if at < 0:
        raise zipfile.BadZipFile("no end of central directory")
    at += max(len(buf) - (_END.size + 0xFFFF), 0)
    _, _, _, _, count, size, offset, _ = _END.unpack(buf[at : at + _END.size])
    loc = at - _LOCATOR64.size
    if loc >= 0 and bytes(buf[loc : loc + 4]) == _SIG_LOCATOR64:
        _, _, end64, _ = _LOCATOR64.unpack(buf[loc : at])
        sig, *_, count, size, offset = _END64.unpack(buf[end64 : end64 + _END64.size])
        if sig != _SIG_END64:
            raise zipfile.BadZipFile("bad zip64 end of central directory")
    members: List[_Member] = []
    pos = offset
    for _ in range(count):
        head = buf[pos : pos + _CENTRAL.size]
        if len(head) < _CENTRAL.size:
            raise zipfile.BadZipFile("central directory out of range")
        (sig, _, _, _, method, _, _, crc, csize, usize, n_name, n_extra, n_comment, _, _, _,
         off) = _CENTRAL.unpack(head)
        if sig != _SIG_CENTRAL:
            raise zipfile.BadZipFile("bad central directory entry")
        pos += _CENTRAL.size
        name = bytes(buf[pos : pos + n_name]).decode()
        usize, csize, off = _zip64(buf[pos + n_name : pos + n_name + n_extra], usize, csize, off)
        members.append(_Member(name, method, crc, csize, usize, off))
        pos += n_name + n_extra + n_comment
    return members


def _zip64(extra: memoryview, usize: int, csize: int, offset: int) -> Tuple[int, int, int]:
    """Sizes and offset with the zip64 field's values where the entry's are
    0xFFFFFFFF."""
    i = 0
    while i + 4 <= len(extra):
        tag, n = struct.unpack("<2H", extra[i : i + 4])
        if tag == 1:
            vals = list(struct.unpack(f"<{n // 8}Q", extra[i + 4 : i + 4 + n - n % 8]))
            usize, csize, offset = [vals.pop(0) if v == 0xFFFFFFFF else v
                                    for v in (usize, csize, offset)]
            break
        i += 4 + n
    return usize, csize, offset

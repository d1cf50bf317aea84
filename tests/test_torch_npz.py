"""The plain checkpoint path's container (``repro_torch/checkpoint/npz.py``):
round trips bit for bit, the encoding chosen from each leaf's bits, the
archive that ``np.load`` and ``zipfile`` accept, zip64 fields, bytes that
depend on the state alone, and damage found on restore."""
from __future__ import annotations

import io
import zipfile
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import npz  # noqa: E402


def _leaves():
    g = torch.Generator().manual_seed(0)
    return [
        torch.randn(3, 5, generator=g),                         # f32
        torch.zeros(3, 5),                                      # zero, reused below
        torch.randn(4, generator=g).half(),                     # f16
        torch.zeros(3, 5),
        torch.tensor([-0.0, 0.0]),                              # zero by value, not by bits
        torch.arange(-3, 3, dtype=torch.int32),                 # int32
        torch.zeros((), dtype=torch.int32),                     # 0-d zero
        torch.tensor(7, dtype=torch.int32),                     # 0-d
        torch.tensor([True, False, True]),                      # bool
        torch.zeros(2, 2, dtype=torch.bool),
        torch.zeros(0, 4),                                      # empty
        torch.zeros(7, dtype=torch.float16),
        torch.zeros(3, 5),
    ]


def _blob(leaves) -> bytes:
    return b"".join(npz.pack(npz.to_host(leaves)).parts)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.numpy().tobytes() == b.numpy().tobytes()


def test_round_trip_bit_for_bit():
    leaves = _leaves()
    r = npz.Reader(_blob(leaves))
    assert len(r) == len(leaves)
    out = [npz.to_device(r.array(i), "cpu") for i in range(len(r))]
    assert all(_same(o, l) for o, l in zip(out, leaves))
    # copies: writing to a restored leaf leaves the blob alone
    out[0].add_(1.0)
    assert _same(npz.to_device(npz.Reader(_blob(leaves)).array(0), "cpu"), leaves[0])


def test_zero_leaves_deflated_once_and_the_others_stored():
    leaves = _leaves()
    members = npz.to_host(leaves)
    zero = [isinstance(m, npz.Zero) for m in members]
    assert zero == [False, True, False, True, False, False, True, False, False, True, True,
                    True, True]
    packed = npz.pack(members)
    # three zero (3, 5) f32 leaves: one deflated, two reusing its bytes
    assert (packed.stored, packed.deflated, packed.reused) == (6, 7, 2)
    blob = b"".join(packed.parts)
    infos = zipfile.ZipFile(io.BytesIO(blob)).infolist()
    assert [i.filename for i in infos] == [f"arr_{i}.npy" for i in range(len(leaves))]
    assert [i.compress_type for i in infos] == \
        [zipfile.ZIP_DEFLATED if z else zipfile.ZIP_STORED for z in zero]
    data = [blob[i.header_offset:][30 + len(i.filename):] for i in infos]  # no extra on these
    assert data[1][: infos[1].compress_size] == data[3][: infos[3].compress_size] == \
        data[12][: infos[12].compress_size]
    r = npz.Reader(blob)
    for i in range(len(r)):
        r.array(i)
    assert r.reused == 2


def test_stored_leaves_are_read_in_place_and_aligned():
    leaves = [torch.randn(100), torch.randn(3, 7).double(), torch.arange(5, dtype=torch.int32)]
    blob = _blob(leaves)
    r = npz.Reader(blob)
    buf = np.frombuffer(blob, np.uint8)
    for i in range(len(r)):
        a = r.array(i)
        assert np.shares_memory(a, buf) and a.flags.aligned and not a.flags.writeable
        # 64-byte aligned from the archive's start
        assert (a.__array_interface__["data"][0] - buf.__array_interface__["data"][0]) % 64 == 0


def test_np_load_and_testzip_accept_the_blob():
    leaves = _leaves()
    blob = _blob(leaves)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert zf.testzip() is None
    z = np.load(io.BytesIO(blob))
    assert z.files == [f"arr_{i}" for i in range(len(leaves))]
    for k, l in zip(z.files, leaves):
        assert z[k].dtype == l.numpy().dtype and z[k].tobytes() == l.numpy().tobytes()
    # a stored member is what np.save writes for the leaf
    buf = io.BytesIO()
    np.save(buf, leaves[0].numpy())
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert zf.read("arr_0.npy") == buf.getvalue()


def test_zip64_fields_when_forced(monkeypatch):
    leaves = _leaves()
    monkeypatch.setattr(npz, "ZIP64_LIMIT", 0)
    blob = _blob(leaves)
    assert b"PK\x06\x06" in blob and b"PK\x06\x07" in blob   # zip64 end record and locator
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert zf.testzip() is None
        for info in zf.infolist():
            assert info.extract_version == 45 and info.extra[:2] == b"\x01\x00"
    z = np.load(io.BytesIO(blob))
    assert all(z[k].tobytes() == l.numpy().tobytes() for k, l in zip(z.files, leaves))
    r = npz.Reader(blob)
    assert all(_same(npz.to_device(r.array(i), "cpu"), l) for i, l in enumerate(leaves))


def test_same_state_same_bytes():
    assert _blob(_leaves()) == _blob(_leaves())
    assert _blob(_leaves()) != _blob(_leaves()[:-1])


def _flip(blob: bytearray, info: zipfile.ZipInfo, offset: int = 0) -> None:
    """Flip a bit in the middle of a member's data (past ``offset`` in the
    archive ``blob``)."""
    at = offset + info.header_offset
    n_name, n_extra = (int.from_bytes(blob[at + k : at + k + 2], "little") for k in (26, 28))
    blob[at + 30 + n_name + n_extra + info.compress_size // 2] ^= 0x10


@pytest.mark.parametrize("member", [0, 1, 3])  # stored, deflated, deflated and reused
def test_a_flipped_byte_raises(member):
    blob = bytearray(_blob(_leaves()))
    with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
        _flip(blob, zf.infolist()[member])
    r = npz.Reader(bytes(blob))
    with pytest.raises(zipfile.BadZipFile):
        for i in range(len(r)):
            r.array(i)


@pytest.mark.parametrize("n", [0, 1, 3, 64, 1000, (1 << 20) + 5, 3 << 22])
def test_crc32_of_zeros(n):
    for crc in (0, zlib.crc32(b"\x93NUMPY header")):
        assert npz.crc32_zeros(crc, n) == zlib.crc32(bytes(n), crc)


@pytest.mark.parametrize("nbytes", [0, 10, 1 << 20, (3 << 20) + 17])
def test_zero_member_deflates_to_its_bytes(nbytes):
    header = b"\x93NUMPY" + bytes(58)
    data = npz._deflate_zeros(header, nbytes)
    assert zlib.decompress(data, -15) == header + bytes(nbytes)
    assert len(data) < 32 + nbytes // 200


@pytest.mark.parametrize("save", [np.savez, np.savez_compressed])
def test_reads_numpys_own_archives(save):
    arrays = [l.numpy() for l in _leaves()]
    buf = io.BytesIO()
    save(buf, *arrays)
    r = npz.Reader(buf.getvalue())
    for i, want in enumerate(arrays):
        got = r.array(i)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes() and got.flags.aligned
    # np.savez_compressed deflates the equal zero leaves to equal bytes
    assert r.reused == (2 if save is np.savez_compressed else 0)


def test_other_methods_go_through_np_load():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros(4, np.int32)]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_BZIP2) as zf:
        for i, a in enumerate(arrays):
            b = io.BytesIO()
            np.save(b, a)
            zf.writestr(f"arr_{i}.npy", b.getvalue())
    r = npz.Reader(buf.getvalue())
    assert [m.method for m in r.members] == [zipfile.ZIP_BZIP2] * 2
    for i, want in enumerate(arrays):
        np.testing.assert_array_equal(r.array(i), want)


def test_reader_over_a_view_of_a_larger_buffer():
    """The trainer hands the reader a view past its JSON header: offsets are
    the archive's own."""
    leaves = _leaves()
    blob = b"x" * 64 + _blob(leaves)
    r = npz.Reader(memoryview(blob)[64:])
    assert all(_same(npz.to_device(r.array(i), "cpu"), l) for i, l in enumerate(leaves))


def test_trainer_restore_raises_on_a_damaged_blob(tmp_path: Path):
    from repro_torch.checkpoint import TrainerStateObject

    leaves = _leaves()
    so = TrainerStateObject(tmp_path, lambda: ({"w": leaves[0]}, {"m": torch.zeros(3, 5)}),
                            step_fn=None, device="cpu")
    blob = bytearray(so._snapshot_blob(0))
    so.store.write(0, bytes(blob), b"meta")
    assert so._restore(0) == b"meta" and _same(so.params["w"], leaves[0])
    _, body = TrainerStateObject._split_blob(bytes(blob))
    with zipfile.ZipFile(io.BytesIO(body)) as zf:
        _flip(blob, zf.getinfo("arr_0.npy"), len(blob) - len(body))   # the stored weight
    so.store.write(1, bytes(blob), b"meta")
    with pytest.raises(zipfile.BadZipFile):
        so._restore(1)

"""RecordStore: a tiny append-only key-value blob store.  Copy of
`rick_tpu/data/store.py`, behaviour unchanged.

Serves the same role as the reference's lmdb environments
(`dataset.py:10-24`): random access to PNG blobs by integer key plus a
'length' entry.  Layout of `<dir>/records.rdb`:

    [8s magic "RICKRDB1"][u64 n]
    [n x (u64 offset, u64 length)]       -- blob table, key i -> entry i
    [blob bytes ...]

The store is read via mmap (zero-copy slices), safe for concurrent readers.
If `path` is an actual lmdb directory and the lmdb package is importable, it
is opened transparently with identical semantics.
"""

from __future__ import annotations

import importlib.util
import mmap
import os
import struct

from rick_tpu_torch.data.lmdb_pure import PureLmdbReader

_MAGIC = b"RICKRDB1"
_FILENAME = "records.rdb"


class RecordStoreWriter:
    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._file = os.path.join(path, _FILENAME)
        self._blobs = []

    def put(self, index: int, blob: bytes):
        while len(self._blobs) <= index:
            self._blobs.append(None)
        self._blobs[index] = blob

    def append(self, blob: bytes):
        self._blobs.append(blob)

    def close(self):
        n = len(self._blobs)
        assert all(b is not None for b in self._blobs), "missing record indices"
        header = _MAGIC + struct.pack("<Q", n)
        table = bytearray()
        offset = len(header) + 16 * n
        for b in self._blobs:
            table += struct.pack("<QQ", offset, len(b))
            offset += len(b)
        # atomic: a killed writer must never leave a truncated records file
        # (a partial store makes the dataset dir look valid to existence
        # checks while every open fails)
        tmp = self._file + ".tmp"
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(bytes(table))
            for b in self._blobs:
                f.write(b)
        os.replace(tmp, self._file)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Reader with the lmdb-dataset access pattern: len() + get(i) -> bytes."""

    def __init__(self, path: str):
        self._file = os.path.join(path, _FILENAME)
        self._fh = open(self._file, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:8] != _MAGIC:
            raise IOError(f"{self._file}: bad magic")
        (self._n,) = struct.unpack_from("<Q", self._mm, 8)
        self._table_off = 16

    def __len__(self):
        return self._n

    def get(self, index: int) -> bytes:
        if not 0 <= index < self._n:
            raise IndexError(index)
        off, length = struct.unpack_from("<QQ", self._mm, self._table_off + 16 * index)
        return self._mm[off : off + length]

    def close(self):
        self._mm.close()
        self._fh.close()


class _LmdbStore:
    """Adapter over a real lmdb environment (reference format,
    `dataset.py:8-34`).  Uses the lmdb package when importable; otherwise
    falls back to the stdlib-only page reader (`data/lmdb_pure.py`), so
    reference datasets are consumable with no optional dependencies."""

    def __init__(self, path: str):
        if importlib.util.find_spec("lmdb") is not None:
            import lmdb  # optional dependency

            self.env = lmdb.open(
                path, max_readers=32, readonly=True, lock=False,
                readahead=False, meminit=False,
            )
            self._pure = None
            with self.env.begin(write=False) as txn:
                self._n = int(txn.get(b"length").decode("utf-8"))
        else:
            self.env = None
            self._pure = PureLmdbReader(path)
            n = self._pure.get(b"length")
            if n is None:
                raise IOError(f"{path}: lmdb environment has no 'length' key")
            self._n = int(n.decode("utf-8"))

    def __len__(self):
        return self._n

    def get(self, index: int) -> bytes:
        key = f"{index:06d}".encode("utf-8")
        if self._pure is not None:
            return self._pure.get(key)
        with self.env.begin(write=False) as txn:
            return txn.get(key)

    def close(self):
        if self._pure is not None:
            self._pure.close()
        else:
            self.env.close()


def open_image_store(path: str):
    """Open a RecordStore directory, or an lmdb directory (reference
    datasets; read via the lmdb package or the stdlib page reader)."""
    if os.path.exists(os.path.join(path, _FILENAME)):
        return RecordStore(path)
    if os.path.exists(os.path.join(path, "data.mdb")):
        return _LmdbStore(path)
    raise IOError(f"no record store found at {path}")

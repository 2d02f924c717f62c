"""Minimal pure-Python READ-ONLY LMDB B+tree reader.  Copy of
`rick_tpu/data/lmdb_pure.py`, behaviour unchanged.

The reference's datasets are LMDB environments (`dataset.py:8-40`,
`prepare_data.py:85`); the lmdb package is an optional dependency here, so
this module lets rick-tpu consume a real `data.mdb` with the standard
library only: mmap the file, parse the meta pages, walk the main DB's B+tree.

Format coverage (everything the reference's writer produces -- plain `put`s
of str keys / PNG-bytes values, no DUPSORT/DUPFIXED/sub-databases):
  * meta pages 0/1 (magic 0xBEEFC0DE, version 1), newest txnid wins
  * branch and leaf pages, default memcmp key ordering
  * F_BIGDATA nodes with contiguous overflow-page chains (image blobs are
    almost always > ~2KB and land here)

Layout constants follow liblmdb 0.9's mdb.c structs on 64-bit builds (the
only layout the python lmdb wheel writes):
  MDB_page header, 16 bytes: pgno u64 | pad u16 | flags u16 | lower u16 |
  upper u16 (overflow pages reuse lower/upper as a u32 page count).
  MDB_node header, 8 bytes: lo u16 | hi u16 | flags u16 | ksize u16; for
  leaves lo|hi<<16 is the data size, for branches lo|hi<<16|flags<<32 the
  child pgno.
  MDB_meta after the page header: magic u32 | version u32 | address u64 |
  mapsize u64 | MDB_db[2] (48 bytes each: pad u32 | flags u16 | depth u16 |
  branch u64 | leaf u64 | overflow u64 | entries u64 | root u64) | last_pg
  u64 | txnid u64; the page size lives in dbs[0].pad.

Validated in tests against files synthesized by an independent writer that
follows the same published layout (the lmdb package itself is unavailable in
this environment -- documented residual risk; `cli/convert_lmdb.py` offers
the package-based conversion path when lmdb IS installed).
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

_MAGIC = 0xBEEFC0DE
_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_P_LEAF2 = 0x20
_F_BIGDATA = 0x01
_F_DUPDATA = 0x04
_PAGEHDRSZ = 16
_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class LmdbReadError(IOError):
    pass


class PureLmdbReader:
    """Read-only accessor for an LMDB environment directory (or data.mdb)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        self.psize = meta["psize"]
        self.entries = meta["entries"]
        self._root = meta["root"]
        if meta["depth"] > 0 and self._root == _INVALID_PGNO:
            raise LmdbReadError("corrupt meta: depth > 0 but invalid root")

    # -- meta ---------------------------------------------------------------

    def _parse_meta(self, off: int) -> Optional[dict]:
        mm = self._mm
        flags = struct.unpack_from("<H", mm, off + 10)[0]
        if not flags & _P_META:
            return None
        m = off + _PAGEHDRSZ
        magic, version = struct.unpack_from("<II", mm, m)
        if magic != _MAGIC:
            return None
        if version not in (1, 999):  # 999 = MDB_DEVEL builds
            raise LmdbReadError(f"unsupported lmdb version {version}")
        psize = struct.unpack_from("<I", mm, m + 24)[0]  # dbs[0].md_pad
        # main DB = dbs[1] at m+24+48
        d = m + 24 + 48
        db_flags, depth = struct.unpack_from("<HH", mm, d + 4)
        entries, root = struct.unpack_from("<QQ", mm, d + 32)
        txnid = struct.unpack_from("<Q", mm, m + 24 + 96 + 8)[0]
        if db_flags & 0x04:  # MDB_DUPSORT main DB -- reference never writes it
            raise LmdbReadError("DUPSORT databases are not supported")
        return {
            "psize": psize, "entries": entries, "root": root,
            "txnid": txnid, "depth": depth,
        }

    def _pick_meta(self) -> dict:
        # meta pages are the first two pages; page size is not yet known, but
        # both 4096 (default) and any power of two place meta1 at `psize`.
        # Read meta0 first to learn psize, then meta1 at that offset.
        m0 = self._parse_meta(0)
        if m0 is None:
            raise LmdbReadError("page 0 is not an LMDB meta page")
        m1 = self._parse_meta(m0["psize"])
        if m1 is None or m0["txnid"] >= m1["txnid"]:
            return m0
        return m1

    # -- pages --------------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int]:
        """(byte offset, flags) of page pgno."""
        off = pgno * self.psize
        if off + _PAGEHDRSZ > len(self._mm):
            raise LmdbReadError(f"page {pgno} beyond file end")
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        return off, flags

    def _node_offsets(self, off: int) -> list:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        n = (lower - _PAGEHDRSZ) // 2
        return list(struct.unpack_from(f"<{n}H", self._mm, off + _PAGEHDRSZ))

    def _leaf_node(self, page_off: int, node_off: int):
        mm = self._mm
        o = page_off + node_off
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", mm, o)
        key = bytes(mm[o + 8 : o + 8 + ksize])
        dsize = lo | (hi << 16)
        if flags & _F_DUPDATA:
            raise LmdbReadError("DUPSORT data encountered")
        if flags & _F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", mm, o + 8 + ksize)[0]
            data = self._overflow(ovf_pgno, dsize)
        else:
            d = o + 8 + ksize
            data = bytes(mm[d : d + dsize])
        return key, data

    def _branch_node(self, page_off: int, node_off: int):
        mm = self._mm
        o = page_off + node_off
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", mm, o)
        pgno = lo | (hi << 16) | (flags << 32)
        key = bytes(mm[o + 8 : o + 8 + ksize])
        return key, pgno

    def _overflow(self, pgno: int, size: int) -> bytes:
        off, flags = self._page(pgno)
        if not flags & _P_OVERFLOW:
            raise LmdbReadError(f"page {pgno} is not an overflow page")
        start = off + _PAGEHDRSZ
        return bytes(self._mm[start : start + size])

    # -- lookup -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == _INVALID_PGNO:
            return None
        pgno = self._root
        for _ in range(64):  # depth bound
            off, flags = self._page(pgno)
            if flags & _P_LEAF2:
                raise LmdbReadError("DUPFIXED (LEAF2) pages are not supported")
            offsets = self._node_offsets(off)
            if flags & _P_LEAF:
                lo_i, hi_i = 0, len(offsets) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k, v = self._leaf_node(off, offsets[mid])
                    if k == key:
                        return v
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            if not flags & _P_BRANCH:
                raise LmdbReadError(f"unexpected page flags {flags:#x}")
            # branch: rightmost child whose key <= target (node 0's key is
            # a don't-care separator)
            chosen = None
            lo_i, hi_i = 1, len(offsets) - 1
            chosen = self._branch_node(off, offsets[0])[1]
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                k, child = self._branch_node(off, offsets[mid])
                if k <= key:
                    chosen = child
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            pgno = chosen
        raise LmdbReadError("B+tree deeper than 64 levels (corrupt file)")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over every (key, value)."""
        if self._root == _INVALID_PGNO:
            return
        stack = [self._root]
        # depth-first with explicit ordering: expand branches onto the stack
        # in reverse so leaves emit left-to-right
        while stack:
            pgno = stack.pop()
            off, flags = self._page(pgno)
            offsets = self._node_offsets(off)
            if flags & _P_LEAF:
                for no in offsets:
                    yield self._leaf_node(off, no)
            elif flags & _P_BRANCH:
                children = [self._branch_node(off, no)[1] for no in offsets]
                stack.extend(reversed(children))
            else:
                raise LmdbReadError(f"unexpected page flags {flags:#x}")

    def close(self):
        self._mm.close()
        self._fh.close()

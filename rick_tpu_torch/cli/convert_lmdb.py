"""Convert a reference LMDB dataset (keys '{i:06d}' -> PNG bytes, plus
'length'; `dataset.py:8-40`) into a record store: `python -m
rick_tpu_torch.cli.convert_lmdb <lmdb dir> <store dir>`.  Port of
`rick_tpu/cli/convert_lmdb.py`.

Optional: the port opens lmdb directories itself (through the lmdb package
where it is installed, else the stdlib page reader `data/lmdb_pure.py`); a
store gives mmap'd reads to runs that come back to the set."""

from __future__ import annotations

import argparse

from rick_tpu_torch.data.store import RecordStoreWriter, _LmdbStore


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="lmdb -> RecordStore conversion")
    p.add_argument("lmdb_path", type=str, help="lmdb environment directory")
    p.add_argument("out_path", type=str, help="RecordStore directory to create")
    args = p.parse_args(argv)

    src = _LmdbStore(args.lmdb_path)
    n = len(src)
    with RecordStoreWriter(args.out_path) as w:
        for i in range(n):
            blob = src.get(i)
            if blob is None:
                raise IOError(f"missing key {i:06d} in {args.lmdb_path}")
            w.put(i, bytes(blob))
    src.close()
    print(f"converted {n} records: {args.lmdb_path} -> {args.out_path}")


if __name__ == "__main__":
    main()

"""Dataset preparation CLI of the port: `python -m
rick_tpu_torch.cli.prepare_data`, with the flags of `rick_tpu.cli.prepare_data`
(the reference's `prepare_data.py:64-86`).  A host tool: it never touches the
card.  The inputs are PNG, JPEG, BMP, TIFF (`.tiff`) or WebP, decoded to
PIL's pixels (`data/prepare.py`)."""

from __future__ import annotations

import argparse

from rick_tpu_torch.data.prepare import prepare_dataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="prepare PNG, JPEG, BMP, TIFF and WebP images into a record store")
    p.add_argument("--input_path", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--size", type=str, default="256")
    p.add_argument("--n_worker", type=int, default=8)
    p.add_argument("--resample", type=str, default="lanczos", choices=["lanczos", "bilinear"])
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    sizes = [int(s.strip()) for s in args.size.split(",")]
    # one store per size, as rick_tpu (the reference's multi-size loop
    # overwrites its keys, the last size winning)
    for size in sizes:
        out = args.output_path if len(sizes) == 1 else f"{args.output_path}_{size}"
        n = prepare_dataset(args.input_path, out, size=size, n_worker=args.n_worker, resample=args.resample)
        print(f"wrote {n} images at {size}px -> {out}")


if __name__ == "__main__":
    main()

"""Stand-alone FID: `python -m rick_tpu_torch.cli.fid <path> <path>`, the
flags and output line of `rick_tpu.cli.fid` (`gan_metrics/fid_score.py:285-308`).
Each path is a `.npy` array, a record store or a directory of PNG images;
`--bootstrap` resamples both sets with replacement `--n_bootstraps` times
(`:241-282`).  Port of `rick_tpu/cli/fid.py`.

It runs on the card (`main(argv, device="cpu")` on the CPU), with TF32 off
for cuDNN and matmuls.  Inception is `default_inception_params()`.
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np
import torch

from rick_tpu_torch.data import ImageDataset, decode_image, get_nsamples, train_transform
from rick_tpu_torch.metrics import calculate_fid_given_images, default_inception_params, inception_from_params


def _load_images(path: str, size: int) -> np.ndarray:
    """(N, 3, H, W) f32 in [-1, 1] from a `.npy` (NCHW or NHWC), a record
    store (`records.rdb` or lmdb's `data.mdb`) or a directory of images
    (`.png`, `.jpg`, `.jpeg`, through `decode_image`)."""
    if path.endswith(".npy"):
        imgs = np.load(path)
        if imgs.shape[1] != 3:
            imgs = imgs.transpose(0, 3, 1, 2)
        return imgs.astype(np.float32)
    if os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "records.rdb")) or os.path.exists(os.path.join(path, "data.mdb"))
    ):
        ds = ImageDataset(path, resolution=size, flip=False)
        return get_nsamples(ds, len(ds))
    files = sorted(str(f) for f in pathlib.Path(path).iterdir() if f.suffix.lower() in (".png", ".jpg", ".jpeg"))
    rng = np.random.default_rng(0)
    imgs = []
    for f in files:
        with open(f, "rb") as fh:
            imgs.append(train_transform(decode_image(fh.read(), name=f), size, rng, flip=False))
    return np.stack(imgs)


def no_tf32() -> None:
    """f32 convolutions and matmuls: the precision the port's checks hold."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str, nargs=2, help="image dirs / .npy / record stores")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--bootstrap", action="store_true")
    p.add_argument("--n_bootstraps", type=int, default=10)
    args = p.parse_args(argv)
    no_tf32()

    model = inception_from_params(default_inception_params(), device=device)
    imgs0 = _load_images(args.path[0], args.size)
    imgs1 = _load_images(args.path[1], args.size)

    if args.bootstrap:
        rng = np.random.default_rng(0)
        fids = []
        n = min(len(imgs0), len(imgs1))
        for _ in range(args.n_bootstraps):
            fids.append(calculate_fid_given_images(
                imgs0[rng.choice(len(imgs0), n, replace=True)],
                imgs1[rng.choice(len(imgs1), n, replace=True)],
                model, args.batch_size,
            ))
        print(f"FID: {np.mean(fids):.4f} ({np.std(fids):.4f})")
    else:
        fid = calculate_fid_given_images(imgs0, imgs1, model, args.batch_size)
        print("FID: ", fid)


if __name__ == "__main__":
    main()

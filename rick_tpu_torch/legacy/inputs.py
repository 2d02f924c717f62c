"""Dataset factory (`gan_training/inputs.py:7-45`): image folders and .npy
arrays.  Port of `rick_tpu/legacy/inputs.py`, through the port's
`decode_image` and `train_transform`.  The reference's cifar10 / lsun
branches need torchvision downloads and raise."""

from __future__ import annotations

import os

import numpy as np

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp")  # rick_tpu's


def get_dataset(name: str, data_dir: str, size: int = 64, *, flip: bool = True):
    """An object with __len__ and get(i, rng) -> (3, size, size) float32 in
    [-1, 1], the reference's transform chain."""
    if name == "image":
        from rick_tpu_torch.data.image import decode_image
        from rick_tpu_torch.data.loader import train_transform

        files = sorted(
            os.path.join(r, f)
            for r, _d, fs in os.walk(data_dir)
            for f in fs
            if os.path.splitext(f)[1].lower() in _IMAGE_EXTS
        )

        class _ImageFolder:
            def __len__(self):
                return len(files)

            def get(self, i, rng):
                with open(files[i], "rb") as fh:
                    return train_transform(decode_image(fh.read(), name=files[i]), size, rng, flip=flip)

        return _ImageFolder()

    if name == "npy":
        arr = np.load(data_dir, mmap_mode="r")

        class _Npy:
            def __len__(self):
                return arr.shape[0]

            def get(self, i, rng):
                x = np.asarray(arr[i], np.float32)
                if x.ndim == 3 and x.shape[-1] in (1, 3):
                    x = x.transpose(2, 0, 1)
                if x.max() > 1.5:
                    x = x / 127.5 - 1.0
                if flip and rng.random() < 0.5:
                    x = x[:, :, ::-1]
                return np.ascontiguousarray(x)

        return _Npy()

    raise NotImplementedError(
        f"dataset '{name}' requires torchvision downloads (no network); supported: image, npy"
    )

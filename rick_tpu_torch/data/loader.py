"""Host-side image loading: decode -> transform -> device.  Port of
`rick_tpu/data/loader.py`.

Decoding is the port's own (`data/image.py::decode_image`: PNG or JPEG, no
cv2, no PIL).  The
transform is `rick_tpu`'s torchvision chain: Resize(size) (shorter side,
bilinear) -> CenterCrop(size) -> RandomHorizontalFlip from the numpy `rng`
-> [-1, 1], CHW float32.  The resize acts only when the stored size differs
from `size`; it is `F.interpolate(bilinear, align_corners=False)` without
antialiasing, rounded to uint8, where `rick_tpu` takes cv2's `INTER_LINEAR`:
cv2 weighs the two taps in 11-bit fixed point, so a pixel may land one level
of 255 apart (1/127.5 after normalization).

`data_stream` runs a host thread that decodes ahead and copies each batch to
the device from pinned memory; `device_data_stream` stages a few-shot set
whole on the device and draws each batch there as a gather and a flip.  Both
take the dataset's `decode_batch` where it has one (`NativeImageDataset`,
`data/native.py`: one C call per batch on a pool of threads, outside the
GIL), and `get` one image at a time otherwise, as `rick_tpu`'s streams do.

Data-parallel runs (`dist/`): the staged stream draws the global batch on
every rank, from the same seeds, and yields the rank's rows of it, so N
ranks see the batches one process sees; the host stream is started per rank
with the local batch size and its own seed (`cli/train.py`), as `rick_tpu`'s.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from rick_tpu_torch.data.image import decode_image
from rick_tpu_torch.dist import Group, local_rows
from rick_tpu_torch.data.store import open_image_store
from rick_tpu_torch.utils.trace import count, span


def _resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(size): scale the shorter side to `size` (bilinear)."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    return y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).numpy()


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


def train_transform(img: np.ndarray, size: int, rng: np.random.Generator, *, flip: bool = True) -> np.ndarray:
    """HWC uint8 -> CHW float32 in [-1, 1], as `rick_tpu`'s chain."""
    img = _resize_shorter(img, size)
    img = _center_crop(img, size)
    if flip and rng.random() < 0.5:
        img = img[:, ::-1]
    out = img.astype(np.float32) / 127.5 - 1.0
    return np.ascontiguousarray(out.transpose(2, 0, 1))


class ImageDataset:
    """RecordStore/lmdb-backed dataset (mirror of `MultiResolutionDataset`)."""

    def __init__(self, path: str, resolution: int = 256, *, flip: bool = True, indices=None):
        self.store = open_image_store(path)
        self.resolution = resolution
        self.flip = flip
        self.indices = list(indices) if indices is not None else list(range(len(self.store)))

    def __len__(self):
        return len(self.indices)

    def get(self, i: int, rng: np.random.Generator) -> np.ndarray:
        blob = self.store.get(self.indices[i])
        return train_transform(decode_image(blob, name=f"record {self.indices[i]}"), self.resolution, rng,
                               flip=self.flip)


def _epoch(rng: np.random.Generator, n: int, batch_size: int, shuffle: bool, drop_last: bool):
    """(order, end) of one epoch, as `rick_tpu` draws it: a permutation cut to
    whole batches, or `batch_size` draws with replacement when the dataset
    is smaller than a batch."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_last else n
    if end == 0:
        order = rng.integers(0, n, size=batch_size)
        end = batch_size
    return order, end


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host batch -> `device`; to the card from pinned memory without blocking."""
    t = torch.from_numpy(batch)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def data_stream(
    dataset: ImageDataset,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    device="cuda",
    prefetch: int = 2,
) -> Iterator[torch.Tensor]:
    """Infinite batch iterator with background prefetch: epoch-shuffled,
    drop-last batches, looping forever, each on `device` (the card unless
    the caller asks for the CPU).  The producer thread decodes and starts the
    copy, so both overlap the training step."""
    device = torch.device(device)
    ready: "collections.deque[torch.Tensor]" = collections.deque()
    cv = threading.Condition()
    stop = threading.Event()

    def producer():
        rng = np.random.default_rng(seed)
        n = len(dataset)
        decode_batch = getattr(dataset, "decode_batch", None)
        while not stop.is_set():
            order, end = _epoch(rng, n, batch_size, shuffle, drop_last)
            for s in range(0, end, batch_size):
                idx = order[s : s + batch_size]
                if decode_batch is not None:  # the threaded batch decoder (data/native.py)
                    batch = decode_batch(idx, rng)
                else:
                    batch = np.stack([dataset.get(int(i), rng) for i in idx])
                batch = _to_device(batch, device)
                with cv:
                    cv.wait_for(lambda: len(ready) < prefetch or stop.is_set())
                    if stop.is_set():
                        return
                    ready.append(batch)
                    cv.notify_all()

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    class _Stream:
        def __iter__(self):
            return self

        def __next__(self):
            with cv:
                while not ready and t.is_alive():  # a thread that died notifies no one
                    cv.wait(0.5)
                if not ready:  # the thread died: its traceback is printed above
                    raise RuntimeError("the data_stream thread ended with an error")
                batch = ready.popleft()
                cv.notify_all()
            return batch

        def close(self):
            with cv:
                stop.set()
                cv.notify_all()
            t.join(timeout=60)

    return _Stream()


def device_data_stream(
    dataset: ImageDataset,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    drop_last: bool = True,
    device="cuda",
    group: Group = None,
):
    """A few-shot dataset staged whole on `device`; each batch is a gather
    and a random horizontal flip there.  `batch_size` is the global batch;
    with a process `group`, each batch is this rank's rows of it.

    The epoch order comes from `np.random.default_rng(seed)`, as in
    `rick_tpu`; the flips from a `torch.Generator` on the device seeded with
    `seed + 13` (`rick_tpu` draws them from `jax.random`, so the flips of the
    two packages differ).  Per iteration only the (batch,) index vector
    crosses to the device."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    n = len(dataset)

    # decode everything once, flips off (the flip happens per draw)
    old_flip = dataset.flip
    dataset.flip = False
    decode_batch = getattr(dataset, "decode_batch", None)
    if decode_batch is not None:
        imgs = decode_batch(np.arange(n), rng)
    else:
        imgs = np.stack([dataset.get(i, rng) for i in range(n)])
    dataset.flip = old_flip
    imgs_dev = torch.from_numpy(imgs).to(device)
    flips = torch.Generator(device=device).manual_seed(seed + 13)

    class _DeviceStream:
        def __init__(self):
            self._order = np.empty((0,), np.int64)
            self._pos = 0

        def __iter__(self):
            return self

        def __next__(self):
            with span("data.next_batch"):
                if self._pos + batch_size > len(self._order):
                    order, end = _epoch(rng, n, batch_size, shuffle, drop_last)
                    self._order = order[:end]
                    self._pos = 0
                idx = torch.from_numpy(self._order[self._pos : self._pos + batch_size].astype(np.int64))
                with count("data.index_upload"):
                    idx = idx.to(device)
                self._pos += batch_size
                b = imgs_dev[idx]
                do = torch.rand((idx.shape[0],), generator=flips, device=device) < 0.5
                return local_rows(torch.where(do[:, None, None, None], b.flip(-1), b), group)

        def close(self):
            pass

    return _DeviceStream()


def get_nsamples(dataset: ImageDataset, n: int, *, seed: int = 0) -> np.ndarray:
    """The first n images (capped at the dataset's size), as
    `get_nsamples_lmdb` (`gan_training/utils.py:38-49`)."""
    rng = np.random.default_rng(seed)
    n = min(n, len(dataset))
    return np.stack([dataset.get(i, rng) for i in range(n)])

"""Data: the record store of PNG blobs, the port's PNG codec and JPEG
decoder, and the image pipeline.  Port of `rick_tpu/data` (store, lmdb page
reader, loader, the threaded batch decoder of `native.py`); `decode_image`
(PNG, JPEG, BMP, TIFF or WebP, by signature) takes the place of cv2 and
PIL."""

from rick_tpu_torch.data.loader import (
    ImageDataset,
    data_stream,
    device_data_stream,
    get_nsamples,
    train_transform,
)
from rick_tpu_torch.data.image import decode_image
from rick_tpu_torch.data.jpeg import decode_jpeg
from rick_tpu_torch.data.native import NativeImageDataset, build_error, native_available
from rick_tpu_torch.data.png import decode_png, encode_png
from rick_tpu_torch.data.store import RecordStore, RecordStoreWriter, open_image_store

__all__ = [
    "ImageDataset",
    "NativeImageDataset",
    "RecordStore",
    "RecordStoreWriter",
    "build_error",
    "data_stream",
    "decode_image",
    "decode_jpeg",
    "decode_png",
    "device_data_stream",
    "encode_png",
    "get_nsamples",
    "native_available",
    "open_image_store",
    "train_transform",
]

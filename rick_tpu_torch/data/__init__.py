"""Data: the record store of PNG blobs, the port's PNG codec and JPEG
decoder, and the image pipeline.  Port of `rick_tpu/data` (store, lmdb page
reader, loader); `decode_image` (PNG or JPEG, by signature) takes the place
of cv2 and PIL."""

from rick_tpu_torch.data.loader import (
    ImageDataset,
    data_stream,
    device_data_stream,
    get_nsamples,
    train_transform,
)
from rick_tpu_torch.data.image import decode_image
from rick_tpu_torch.data.jpeg import decode_jpeg
from rick_tpu_torch.data.png import decode_png, encode_png
from rick_tpu_torch.data.store import RecordStore, RecordStoreWriter, open_image_store

__all__ = [
    "ImageDataset",
    "RecordStore",
    "RecordStoreWriter",
    "data_stream",
    "decode_image",
    "decode_jpeg",
    "decode_png",
    "device_data_stream",
    "encode_png",
    "get_nsamples",
    "open_image_store",
    "train_transform",
]

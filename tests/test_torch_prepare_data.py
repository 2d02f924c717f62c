"""The port's data-prep CLIs against rick_tpu's, on the CPU.

`prepare_data`: PNG inputs upscaled, downscaled, at size on their shorter
side, of odd aspect, grey and RGBA, through rick_tpu's PIL pipeline and the
port's numpy one; the decoded pixels of every record equal, for LANCZOS and
BILINEAR (the blobs differ: PIL's encoder filters rows adaptively).  A
folder of JPEG and PNG inputs gives the pixels of rick_tpu's store; a JPEG
the decoder refuses (arithmetic-coded, CMYK) raises, naming the file.  `pil_resize` alone against PIL on random
shapes.  `convert_lmdb`: tests/lmdb_synth.py's store through both CLIs, the
same blobs."""

import numpy as np
import pytest
from PIL import Image

from rick_tpu.cli.convert_lmdb import main as j_convert_main
from rick_tpu.cli.prepare_data import main as j_prepare_main
from rick_tpu.data.prepare import prepare_dataset as j_prepare_dataset
from rick_tpu_torch.cli import convert_lmdb, prepare_data
from rick_tpu_torch.data import RecordStore, decode_png
from rick_tpu_torch.data.prepare import pil_resize, prepare_dataset
from tests.lmdb_synth import write_synth_lmdb

# (subdir, name, (h, w), PIL mode): every case of the resize at size 16
INPUTS = [
    ("a", "up.png", (10, 12), "RGB"),  # both sides below: upscaled
    ("a", "down.png", (40, 33), "RGB"),  # downscaled
    ("a", "at_size.png", (16, 50), "RGB"),  # shorter side at size: cropped only
    ("b", "odd.png", (23, 77), "RGB"),  # odd aspect, downscaled
    ("b", "grey.png", (19, 27), "L"),
    ("b", "rgba.png", (35, 21), "RGBA"),
    ("c", "tall.png", (90, 17), "RGB"),
]


def _write_inputs(root):
    rng = np.random.default_rng(0)
    for sub, name, (h, w), mode in INPUTS:
        channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        small = rng.integers(0, 256, (max(h // 3, 2), max(w // 3, 2), channels), dtype=np.uint8)
        img = Image.fromarray(small.squeeze(-1) if channels == 1 else small, mode).resize((w, h), Image.BILINEAR)
        noise = rng.integers(-20, 21, (h, w, channels)).squeeze()
        img = Image.fromarray(np.clip(np.asarray(img).astype(int) + noise, 0, 255).astype(np.uint8), mode)
        (root / sub).mkdir(parents=True, exist_ok=True)
        img.save(root / sub / name)


def _pixels(path):
    store = RecordStore(str(path))
    out = [decode_png(store.get(i)) for i in range(len(store))]
    store.close()
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    _write_inputs(root)
    return root


@pytest.mark.parametrize("size", [16, 24])
@pytest.mark.parametrize("resample", ["lanczos", "bilinear"])
def test_prepare_dataset_pixels_equal_rick_tpus(inputs, tmp_path, resample, size):
    n = prepare_dataset(str(inputs), str(tmp_path / "port"), size=size, n_worker=1, resample=resample)
    assert n == j_prepare_dataset(str(inputs), str(tmp_path / "jax"), size=size, n_worker=1, resample=resample)
    got, want = _pixels(tmp_path / "port"), _pixels(tmp_path / "jax")
    assert len(got) == len(want) == len(INPUTS)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (size, size, 3), i
        np.testing.assert_array_equal(a, b, err_msg=f"record {i}")


def test_cli_sizes_and_worker_pool_equal_rick_tpus(inputs, tmp_path, capsys):
    """Two sizes give two stores (`<out>_16`, `<out>_24`), through a pool of
    2 spawned workers on the port's side."""
    flags = ["--input_path", str(inputs), "--size", "16,24", "--resample", "bilinear"]
    prepare_data.main(flags + ["--output_path", str(tmp_path / "port"), "--n_worker", "2"])
    j_prepare_main(flags + ["--output_path", str(tmp_path / "jax"), "--n_worker", "1"])
    assert capsys.readouterr().out.count("wrote 7 images") == 4
    for size in (16, 24):
        for a, b in zip(_pixels(tmp_path / f"port_{size}"), _pixels(tmp_path / f"jax_{size}")):
            np.testing.assert_array_equal(a, b)


def test_a_jpeg_input_raises_naming_the_file(tmp_path):
    """JPEG inputs are decoded now; one the decoder refuses still raises,
    naming the file and what it is."""
    (tmp_path / "arith").mkdir()
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(tmp_path / "arith" / "x.jpg")
    blob = (tmp_path / "arith" / "x.jpg").read_bytes()
    (tmp_path / "arith" / "x.jpg").write_bytes(blob.replace(b"\xff\xc0", b"\xff\xc9", 1))  # SOF9
    with pytest.raises(ValueError, match="x.jpg.*JPEG is arithmetic-coded"):
        prepare_dataset(str(tmp_path / "arith"), str(tmp_path / "out"), size=16, n_worker=1)
    (tmp_path / "cmyk").mkdir()
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).convert("CMYK").save(tmp_path / "cmyk" / "y.jpeg")
    with pytest.raises(ValueError, match="y.jpeg.*JPEG has 4 components"):
        prepare_dataset(str(tmp_path / "cmyk"), str(tmp_path / "out2"), size=16, n_worker=1)


# JPEG inputs beside PNG ones: (subdir, name, (h, w), PIL mode, save options)
JPEG_INPUTS = [
    ("a", "baseline.jpg", (40, 33), "RGB", dict(quality=90, subsampling=2)),
    ("a", "progressive.jpeg", (23, 77), "RGB", dict(quality=75, progressive=True)),
    ("a", "png_too.png", (19, 27), "RGB", {}),
    ("b", "gray.JPG", (35, 21), "L", dict(quality=85)),
    ("b", "422_restart.jpg", (16, 50), "RGB", dict(subsampling=1, restart_marker_blocks=2)),
    ("c", "444_small.jpg", (10, 12), "RGB", dict(subsampling=0, quality=100)),
]


@pytest.mark.parametrize("size", [16, 24])
@pytest.mark.parametrize("resample", ["lanczos", "bilinear"])
def test_prepare_dataset_of_jpeg_inputs_equals_rick_tpus(tmp_path, resample, size):
    rng = np.random.default_rng(12)
    for sub, name, (h, w), mode, options in JPEG_INPUTS:
        small = rng.integers(0, 256, (max(h // 3, 2), max(w // 3, 2), 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        (tmp_path / "in" / sub).mkdir(parents=True, exist_ok=True)
        (img.convert(mode) if mode != "RGB" else img).save(tmp_path / "in" / sub / name,
                                                           format="PNG" if name.endswith(".png") else "JPEG",
                                                           **options)
    n = prepare_dataset(str(tmp_path / "in"), str(tmp_path / "port"), size=size, n_worker=1, resample=resample)
    assert n == j_prepare_dataset(str(tmp_path / "in"), str(tmp_path / "jax"), size=size, n_worker=1,
                                  resample=resample) == len(JPEG_INPUTS)
    for i, (a, b) in enumerate(zip(_pixels(tmp_path / "port"), _pixels(tmp_path / "jax"))):
        assert a.shape == b.shape == (size, size, 3), i
        np.testing.assert_array_equal(a, b, err_msg=f"record {i}")


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("resample", ["lanczos", "bilinear"])
def test_pil_resize_equals_pil(resample, case):
    """Random sizes in and out, up and down on each axis independently."""
    rng = np.random.default_rng(100 + case)
    h, w = (int(v) for v in rng.integers(2, 70, 2))
    nh, nw = (int(v) for v in rng.integers(1, 90, 2))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    filt = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR}[resample]
    np.testing.assert_array_equal(pil_resize(img, nw, nh, resample), np.asarray(Image.fromarray(img).resize((nw, nh),
                                                                                                           filt)))


def test_convert_lmdb_equals_rick_tpus(tmp_path, capsys):
    rng = np.random.default_rng(2)
    kv = {b"length": b"4"}
    for i in range(4):
        kv[f"{i:06d}".encode()] = rng.integers(0, 256, 1500 + 700 * i, dtype=np.uint8).tobytes()
    write_synth_lmdb(str(tmp_path / "src"), kv)
    convert_lmdb.main([str(tmp_path / "src"), str(tmp_path / "port")])
    j_convert_main([str(tmp_path / "src"), str(tmp_path / "jax")])
    assert "converted 4 records" in capsys.readouterr().out
    a, b = RecordStore(str(tmp_path / "port")), RecordStore(str(tmp_path / "jax"))
    assert len(a) == len(b) == 4
    assert all(bytes(a.get(i)) == bytes(b.get(i)) == kv[f"{i:06d}".encode()] for i in range(4))
    a.close()
    b.close()

"""The port's JPEG codec (``nerf_texture_tpu_torch.data.jpeg``) against
PIL, which bundles libjpeg-turbo: files PIL writes -- gray, 4:4:4, 4:2:2
and 4:2:0, qualities 50, 85 and 95, sizes that are not a multiple of 16,
restart intervals and ``optimize=True`` Huffman tables -- decode to PIL's
pixels bit for bit; the port's encoding of an RGB image (4:2:0, PIL's
default, and 4:4:4) is the file PIL writes, byte for byte, so PIL decodes
it to what it decodes its own file to; lossless, arithmetic-coded,
hierarchical and 12-bit files raise (progressive files:
``test_torch_image_formats.py``).
"""

import io

import numpy as np
import pytest
from PIL import Image

from nerf_texture_tpu_torch.data import jpeg

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _image(h: int, w: int, channels: int, seed: int) -> np.ndarray:
    """Smooth colour structure plus noise: every coefficient band and
    run length occurs."""
    rng = np.random.default_rng(seed)
    coarse = (rng.random((h // 4 + 2, w // 4 + 2, channels)) * 255).astype(
        np.uint8)
    img = np.asarray(Image.fromarray(coarse.squeeze(-1) if channels == 1
                                     else coarse).resize((w, h),
                                                         Image.BICUBIC))
    img = img.astype(np.float64) + rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_bytes(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


CASES = [(kind, q, (h, w)) for kind in ("gray", *SUBSAMPLING)
         for q, (h, w) in ((50, (37, 45)), (85, (61, 130)), (95, (100, 99)))]


@pytest.mark.parametrize("kind,quality,size", CASES)
@pytest.mark.parametrize("variant", ["plain", "optimize", "restart"])
def test_decode_matches_pil(kind, quality, size, variant):
    img = _image(*size, 1 if kind == "gray" else 3, seed=quality)
    kw = {"quality": quality}
    if kind != "gray":
        kw["subsampling"] = SUBSAMPLING[kind]
    if variant == "optimize":
        kw["optimize"] = True
    elif variant == "restart":
        kw["restart_marker_blocks"] = 3
    data = _pil_bytes(img, **kw)
    if variant == "restart":
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got = jpeg.decode(data)
    want = _pil_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,quality,size",
                         [c for c in CASES if c[0] in jpeg.SUBSAMPLING])
def test_encode_matches_pil(kind, quality, size):
    img = _image(*size, 3, seed=quality + 1)
    ours = jpeg.encode(img, quality=quality, subsampling=kind)
    theirs = _pil_bytes(img, quality=quality,
                        subsampling=SUBSAMPLING[kind])
    np.testing.assert_array_equal(_pil_decode(ours), _pil_decode(theirs))
    assert ours == theirs


def test_encode_default_is_pils_and_round_trips(tmp_path):
    """quality 85 4:2:0 (the viewer's stream) is PIL's default layout;
    write_jpeg / read_jpeg round trip through a file."""
    img = _image(48, 80, 3, seed=4)
    assert jpeg.encode(img, quality=85) == _pil_bytes(img, quality=85)
    path = str(tmp_path / "f.jpg")
    jpeg.write_jpeg(path, img, quality=95, subsampling="4:4:4")
    np.testing.assert_array_equal(jpeg.read_jpeg(path),
                                  np.asarray(Image.open(path)))


def _with_marker(data: bytes, sof: int, precision: int = 8) -> bytes:
    """A baseline file with its SOF0 marker replaced by ``sof`` and its
    sample precision by ``precision``."""
    k = data.index(b"\xff\xc0")
    return data[:k + 1] + bytes([sof]) + data[k + 2:k + 4] + \
        bytes([precision]) + data[k + 5:]


def test_unsupported_files_raise():
    """What still raises: lossless (SOF3), arithmetic-coded (SOF9) and
    hierarchical (SOF5) frames, 12-bit samples (also when progressive),
    and a file that is not a JPEG; the encoder's refusals."""
    img = _image(24, 24, 3, seed=5)
    base = _pil_bytes(img, quality=85)
    for sof, kind in ((0xC3, "lossless"), (0xC9, "arithmetic-coded"),
                      (0xCB, "lossless"), (0xC5, "hierarchical")):
        with pytest.raises(ValueError,
                           match=f"x.jpg: {kind} JPEG.*11.7"):
            jpeg.decode(_with_marker(base, sof), name="x.jpg")
    for sof in (0xC0, 0xC1, 0xC2):
        with pytest.raises(ValueError, match="12-bit JPEG samples.*11.7"):
            jpeg.decode(_with_marker(base, sof, precision=12))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG....")
    for bad in (np.zeros((8, 8, 4), np.uint8), np.zeros((8, 8), np.uint8),
                np.zeros((8, 8, 3), np.float32)):
        with pytest.raises(ValueError, match="RGB only"):
            jpeg.encode(bad)
    with pytest.raises(ValueError, match="subsampling"):
        jpeg.encode(img, subsampling="4:2:2")

"""Every image kind the JAX loader reads, read by the port without an image
library: palette PNGs (1-8 bits, with and without ``tRNS``), 2- and 4-bit
gray, Adam7 interlace for every colour type and depth, and progressive
JPEG (spectral selection, successive approximation, restart intervals),
held bit for bit to ``imageio.v3.imread`` and to the JAX package's
``provider._load_image``; scenes of such frames through both packages'
``NeRFDataset``; and the committed fixtures of ``tests/fixtures/formats/``
(which ``chip_smoke.py`` decodes on the card's machine) against the
arrays stored beside them and against imageio today.
"""

import hashlib
import importlib.util
import io
import json
import os
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from nerf_texture_tpu.data import provider as jprov
from nerf_texture_tpu.data.synthetic import (
    SyntheticSphereDataset as JaxSphere)
from nerf_texture_tpu_torch.data import images, jpeg, provider

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "formats"
_spec = importlib.util.spec_from_file_location(
    "make_format_fixtures", REPO / "scripts" / "make_format_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _same_as_jax(path):
    """The port's raw read equals imageio's, its scene read the JAX
    loader's: dtype, shape and every value."""
    want, got = iio.imread(path), images.read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want, got = jprov._load_image(path), images.load_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_matches_imageio(tmp_path, depth, trns, interlace):
    """Expanded through PLTE to RGB (tRNS dropped, as imageio converts to
    the palette's mode); the palette is one entry short, so an index past
    it occurs and reads black."""
    rng = np.random.default_rng(depth + 10 * trns + 100 * interlace)
    n = 1 << depth
    idx = rng.integers(0, n, (13, 11, 1))
    plte = rng.integers(0, 256, 3 * max(1, n - 1), dtype=np.uint8).tobytes()
    t = bytes(rng.integers(0, 256, min(n, 7), dtype=np.uint8)) if trns \
        else None
    path = _write(tmp_path, "p.png", fx.png_bytes(
        idx, depth, 3, plte=plte, trns=t, interlace=interlace,
        filters=(0, 1, 2, 3, 4)))
    _same_as_jax(path)
    assert images.read_png(path).shape == (13, 11, 3)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth", [2, 4])
def test_sub_byte_gray_matches_imageio(tmp_path, depth, interlace):
    """PIL's L;2 / L;4 modes: the samples scaled to 8 bits."""
    rng = np.random.default_rng(depth + interlace)
    g = rng.integers(0, 1 << depth, (10, 23, 1))
    g[0, :1 << depth, 0] = np.arange(1 << depth)
    path = _write(tmp_path, "g.png", fx.png_bytes(
        g, depth, 0, interlace=interlace, filters=(4, 3, 2, 1, 0)))
    _same_as_jax(path)
    scale = 255 // ((1 << depth) - 1)
    np.testing.assert_array_equal(images.read_png(path)[0, :1 << depth],
                                  np.arange(1 << depth) * scale)


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (9, 13), (17, 8)])
@pytest.mark.parametrize("ctype,depth", [
    (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 4),
    (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_adam7_every_kind_matches_imageio(tmp_path, ctype, depth, size):
    """Adam7 for every colour type and depth (1-bit gray is the raise
    below): each pass filtered on its own, some passes empty."""
    h, w = size
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 100 + depth + h)
    s = rng.integers(0, 1 << depth, (h, w, c))
    plte = rng.integers(0, 256, 3 << depth, dtype=np.uint8).tobytes() \
        if ctype == 3 else None
    path = _write(tmp_path, "a.png", fx.png_bytes(
        s, depth, ctype, plte=plte, interlace=1, filters=(0, 1, 2, 3, 4)))
    _same_as_jax(path)
    plain = _write(tmp_path, "n.png", fx.png_bytes(s, depth, ctype,
                                                   plte=plte))
    np.testing.assert_array_equal(images.read_png(path),
                                  images.read_png(plain))


@pytest.mark.parametrize("interlace", [0, 1])
def test_one_bit_gray_raises_in_both_loaders(tmp_path, interlace):
    """imageio reads 1-bit gray as booleans (the port's ``read_image``
    too); the JAX loader then raises, and so does the port's."""
    g = np.random.default_rng(interlace).integers(0, 2, (7, 19, 1))
    path = _write(tmp_path, "b.png", fx.png_bytes(g, 1, 0,
                                                  interlace=interlace))
    want, got = iio.imread(path), images.read_image(path)
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        jprov._load_image(path)
    with pytest.raises(ValueError, match="1-bit gray PNG.*booleans"):
        images.load_image(path)


def test_malformed_palettes(tmp_path):
    """An index past a short (or empty) palette reads black in both; a
    palette PNG without PLTE, or with more than 256 entries, raises in
    both."""
    idx = np.array([[0, 1, 5, 200, 255]]).reshape(1, 5, 1)
    for name, plte in (("short", bytes(range(7))), ("empty", b"")):
        _same_as_jax(_write(tmp_path, f"{name}.png",
                            fx.png_bytes(idx, 8, 3, plte=plte)))
    for name, plte, match in (("none", None, "without a PLTE"),
                              ("big", bytes(800), "palette size")):
        path = _write(tmp_path, f"{name}.png",
                      fx.png_bytes(idx, 8, 3, plte=plte))
        with pytest.raises(Exception):
            iio.imread(path)
        with pytest.raises(ValueError, match=match):
            images.read_png(path)


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
CASES = [(kind, q, size) for kind in ("gray", *SUBSAMPLING)
         for q, size in ((50, (37, 45)), (85, (61, 130)), (95, (100, 99)))]


@pytest.mark.parametrize("kind,quality,size", CASES)
@pytest.mark.parametrize("variant", ["plain", "optimize", "restart"])
def test_progressive_jpeg_matches_pil(tmp_path, kind, quality, size,
                                      variant):
    """PIL's progressive files (libjpeg-turbo's scan script: interleaved DC
    scans with successive approximation, AC bands per component, AC
    refinement) decode to PIL's pixels and load as the JAX loader loads
    them."""
    img = fx.smooth_image(*size, 1 if kind == "gray" else 3, seed=quality)
    kw = {"quality": quality, "progressive": True}
    if kind == "gray":
        img = img[..., 0]
    else:
        kw["subsampling"] = SUBSAMPLING[kind]
    if variant == "optimize":
        kw["optimize"] = True
    elif variant == "restart":
        kw["restart_marker_blocks"] = 3
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    data = buf.getvalue()
    assert b"\xff\xc2" in data
    if variant == "restart":
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got, want = jpeg.decode(data), np.asarray(Image.open(io.BytesIO(data)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    _same_as_jax(_write(tmp_path, "f.jpg", data))


def test_progressive_jpeg_left_unrefined_raises():
    """A progressive file cut after its first scans leaves coefficients
    that libjpeg block-smooths; the port raises naming the reason."""
    img = fx.smooth_image(32, 40, 3, seed=3)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=85,
                              progressive=True)
    data = buf.getvalue()
    cut = data.index(b"\xff\xda", data.index(b"\xff\xda") + 2)
    truncated = data[:cut] + b"\xff\xd9"
    with pytest.raises(ValueError, match="unrefined.*block-smooths"):
        jpeg.decode(truncated)


# ---------------------------------------------------------------------------
# scenes, and the committed fixtures
# ---------------------------------------------------------------------------

def test_scene_of_every_kind_matches_jax(tmp_path):
    """A colmap scene of RGB frames: 4-bit palette PNGs (one of them
    Adam7), Adam7 PNGs and progressive JPEGs; both packages'
    NeRFDataset give the same arrays bit for bit."""
    path = str(tmp_path)
    ds = JaxSphere(n_frames=6, H=27, W=33, seed=2)
    ds.write_to_disk(path)
    with open(os.path.join(path, "transforms.json")) as f:
        meta = json.load(f)
    rng = np.random.default_rng(0)
    for k, fr in enumerate(meta["frames"]):
        src = os.path.join(path, fr["file_path"])
        rgba = iio.imread(src)
        rgb = rgba[..., :3]
        stem = os.path.splitext(src)[0]
        if k % 3 == 0:
            # a palette of the frame's own colours (at most 16)
            q = (rgb // 64).astype(np.int64)
            idx = q[..., 0] * 16 + q[..., 1] * 4 + q[..., 2]
            lut = rng.integers(0, 256, (64, 3), dtype=np.uint8)
            data = fx.png_bytes((idx % 16)[..., None], 4, 3,
                                plte=lut[:16].tobytes(),
                                interlace=k % 2, filters=(4, 1))
            new = stem + ".png"
        elif k % 3 == 1:
            data = fx.png_bytes(rgb, 8, 2, interlace=1,
                                filters=(0, 1, 2, 3, 4))
            new = stem + ".png"
        else:
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, format="JPEG", quality=90,
                                      progressive=True)
            data = buf.getvalue()
            new = stem + ".jpg"
        os.remove(src)
        with open(new, "wb") as f:
            f.write(data)
        fr["file_path"] = os.path.relpath(new, path)
    with open(os.path.join(path, "transforms.json"), "w") as f:
        json.dump(meta, f)
    for kw in ({"split": "all"}, {"split": "train", "downscale": 2}):
        ours = provider.NeRFDataset(path, **kw)
        theirs = jprov.NeRFDataset(path, **kw)
        for name in ("poses", "images", "intrinsics"):
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert ours.radius == theirs.radius


def _manifest():
    with open(FIXTURES / "manifest.json") as f:
        return json.load(f)


def _equal_to(arr, want):
    if "npy" in want:
        ref = np.load(FIXTURES / want["npy"], allow_pickle=False)
        return (arr.dtype == ref.dtype and arr.shape == ref.shape
                and np.array_equal(arr, ref))
    return (str(arr.dtype) == want["dtype"]
            and list(arr.shape) == want["shape"]
            and hashlib.sha256(np.ascontiguousarray(arr).tobytes())
            .hexdigest() == want["sha256"])


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_committed_fixture(name):
    """The port decodes each committed fixture to its stored arrays, and
    the stored arrays are still what imageio and the JAX loader give."""
    entry = _manifest()[name]
    path = str(FIXTURES / name)
    assert _equal_to(images.read_image(path), entry["imread"])
    assert _equal_to(iio.imread(path), entry["imread"])
    if "raises" in entry["load"]:
        with pytest.raises(ValueError):
            images.load_image(path)
        with pytest.raises(ValueError):
            jprov._load_image(path)
    else:
        assert _equal_to(images.load_image(path), entry["load"])
        assert _equal_to(jprov._load_image(path), entry["load"])


def test_fixtures_cover_the_kinds_and_fit_their_budget():
    names = set(_manifest())
    for depth in (1, 2, 4, 8):
        assert {f"palette{depth}.png", f"palette{depth}_trns.png"} <= names
    assert {"gray1.png", "gray2.png", "gray4.png", "adam7_rgb.png",
            "adam7_rgba.png", "adam7_gray.png", "adam7_palette8.png",
            "progressive_444_q95.jpg", "progressive_422_q50.jpg",
            "progressive_420_q85.jpg", "progressive_gray_q85.jpg",
            "progressive_420_restart.jpg", "progressive_gray_restart.jpg",
            "progressive_sphere_800.jpg"} <= names
    assert _manifest()["progressive_sphere_800.jpg"]["imread"]["shape"] == \
        [800, 800, 3]
    size = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert size <= 512 * 1024, size

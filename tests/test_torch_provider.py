"""The port's scene loader vs the JAX package's: ``data.images`` (a PNG
reader on zlib and numpy, PIL's Lanczos in integer arithmetic) against
imageio and PIL, and ``data.provider.NeRFDataset`` against the JAX
``NeRFDataset`` on the same scene directories.

Every comparison is bit for bit: poses, intrinsics and radius come from
the same numpy code on the same json (the port keeps a copy of it), and
the images are decoded and resampled with the libraries' own integer
arithmetic.
"""

import json
import os
import struct
import sys
import zlib

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from nerf_texture_tpu.data import poses as jposes
from nerf_texture_tpu.data import provider as jprov
from nerf_texture_tpu.data.synthetic import (
    SyntheticSphereDataset as JaxSphere)
from nerf_texture_tpu_torch.data import images, poses, provider
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset


def _same(ours, theirs):
    for name in ("poses", "images", "intrinsics"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.radius == theirs.radius
    assert (ours.H, ours.W, ours.num_frames) == (theirs.H, theirs.W,
                                                  theirs.num_frames)


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("colmap"))
    JaxSphere(n_frames=5, H=36, W=44, seed=3).write_to_disk(path)
    return path


@pytest.mark.parametrize("split", ["train", "val", "all"])
@pytest.mark.parametrize("kw", [{}, {"scale": 1.0}, {"max_data_num": 2},
                                {"normalize": False}])
def test_colmap_scene_matches_jax(colmap_scene, split, kw):
    ours = provider.NeRFDataset(colmap_scene, mode="colmap", split=split,
                                **kw)
    theirs = jprov.NeRFDataset(colmap_scene, mode="colmap", split=split,
                               **kw)
    _same(ours, theirs)
    n = {"train": 4, "val": 1, "all": 5}[split]
    assert ours.num_frames == min(n, kw.get("max_data_num", n))


def _blender_scene(path, ds, splits=("train", "val", "test"), **camera):
    """A blender-mode scene of ``ds``: frames dealt round-robin over the
    splits, paths without extension, the camera as given."""
    os.makedirs(os.path.join(path, "imgs"), exist_ok=True)
    frames = {s: [] for s in splits}
    for k in range(ds.num_frames):
        ngp = ds.poses[k]
        nerf = np.eye(4, dtype=np.float32)
        nerf[0] = [ngp[2, 0], -ngp[2, 1], -ngp[2, 2], ngp[2, 3]]
        nerf[1] = [ngp[0, 0], -ngp[0, 1], -ngp[0, 2], ngp[0, 3]]
        nerf[2] = [ngp[1, 0], -ngp[1, 1], -ngp[1, 2], ngp[1, 3]]
        name = f"imgs/r_{k}"
        iio.imwrite(os.path.join(path, name + ".png"), ds.images[k])
        frames[splits[k % len(splits)]].append(
            {"file_path": name, "transform_matrix": nerf.tolist()})
    for s in splits:
        with open(os.path.join(path, f"transforms_{s}.json"), "w") as f:
            json.dump({**camera, "frames": frames[s]}, f)


@pytest.mark.parametrize("camera", [
    {"camera_angle_x": 0.7},
    {"camera_angle_y": 0.6},
    {"camera_angle_x": 0.7, "camera_angle_y": 0.5, "cx": 20.5},
    {"fl_y": 33.0, "cy": 17.0},
    {"fl_x": 30.0, "fl_y": 31.0, "cx": 21.0, "cy": 18.0, "h": 36, "w": 44},
])
@pytest.mark.parametrize("split", ["train", "test", "all"])
def test_blender_scene_matches_jax(tmp_path, camera, split):
    ds = JaxSphere(n_frames=7, H=36, W=44, seed=1)
    _blender_scene(str(tmp_path), ds, **camera)
    for kw in ({}, {"downscale": 2}):
        ours = provider.NeRFDataset(str(tmp_path), mode="blender",
                                    split=split, **kw)
        theirs = jprov.NeRFDataset(str(tmp_path), mode="blender",
                                   split=split, **kw)
        _same(ours, theirs)
    assert provider.NeRFDataset(str(tmp_path), mode="blender",
                                split="all").num_frames == 7


@pytest.mark.parametrize("downscale", [2, 3])
def test_downscaled_scene_matches_jax(colmap_scene, downscale):
    ours = provider.NeRFDataset(colmap_scene, downscale=downscale)
    theirs = jprov.NeRFDataset(colmap_scene, downscale=downscale)
    _same(ours, theirs)
    assert ours.images.shape[1:3] == (36 // downscale, 44 // downscale)


def test_missing_focal_and_mode_raise(tmp_path):
    with open(tmp_path / "transforms.json", "w") as f:
        json.dump({"frames": []}, f)
    with pytest.raises(RuntimeError, match="no focal length"):
        provider.load_intrinsics({"frames": []}, 10, 10, 1)
    with pytest.raises(ValueError, match="unknown dataset mode"):
        provider.NeRFDataset(str(tmp_path), mode="llff")


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        m = rng.normal(size=(4, 4)).astype(np.float32)
        for scale in (0.33, 1.0):
            np.testing.assert_array_equal(
                poses.nerf_matrix_to_ngp(m, scale),
                jposes.nerf_matrix_to_ngp(m, scale))
    cps = np.stack([poses.orbit_pose(t, p, 2.0 + 0.1 * t) for t, p in
                    rng.uniform(0.5, 2.5, (9, 2))]).astype(np.float32)
    cps[:, :3, 3] += rng.normal(size=3).astype(np.float32)
    np.testing.assert_array_equal(poses.centralize_cps(cps),
                                  jposes.centralize_cps(cps))
    a, ra = poses.normalize_cps(cps, scale=1.2)
    b, rb = jposes.normalize_cps(cps, scale=1.2)
    np.testing.assert_array_equal(a, b)
    assert ra == rb
    np.testing.assert_array_equal(
        poses.min_line_dist_center(cps[:, :3, 3], cps[:, :3, 2]),
        jposes.min_line_dist_center(cps[:, :3, 3], cps[:, :3, 2]))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png(path, rows: np.ndarray, depth: int, ctype: int, filters=None,
         palette=False, interlace=0, palette_bytes=bytes(range(48))):
    """A hand-built PNG of samples rows [H, W, C] (uint8 or uint16), each
    row written with its filter type (default 0)."""
    h, w = rows.shape[:2]
    raw = rows.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1)
    raw = raw.view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = max(1, rows.shape[2] * depth // 8)
    filters = filters if filters is not None else [0] * h
    out = []
    prev = np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        cur, ft = raw[y], filters[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            enc = cur
        elif ft == 1:
            enc = cur - left
        elif ft == 2:
            enc = cur - prev
        elif ft == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            enc = cur - pred
        out.append(bytes([ft]) + (enc % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      interlace))
    if palette:
        body += chunk(b"PLTE", palette_bytes)
    with open(path, "wb") as f:
        f.write(images.PNG_SIGNATURE + body
                + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("depth,ctype", [(8, 2), (8, 6), (8, 0), (8, 4),
                                         (16, 2), (16, 6), (16, 0),
                                         (16, 4)])
def test_png_filters_match_imageio(tmp_path, ftype, depth, ctype):
    rng = np.random.default_rng(ftype + 10 * ctype + depth)
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rows = rng.integers(0, 2 ** depth, (9, 13, c))
    # smooth rows too, where the predictors matter
    rows[5:] = (np.arange(13)[None, :, None] * 7 + np.arange(4)[:, None,
                                                                 None] * 3
                ) % (2 ** depth)
    path = str(tmp_path / "f.png")
    # row 0 plain, the others the filter under test (and every filter once)
    _png(path, rows, depth, ctype, filters=[0] + [ftype] * 7 + [4])
    want = iio.imread(path)
    got = images.read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(images.load_image(path),
                                  jprov._load_image(path))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "I;16"])
def test_png_written_by_pil_matches_imageio(tmp_path, mode):
    """PNGs as PIL writes them (its adaptive row filters)."""
    rng = np.random.default_rng(len(mode))
    shape = {"RGB": (31, 27, 3), "RGBA": (31, 27, 4), "L": (31, 27),
             "LA": (31, 27, 2), "I;16": (31, 27)}[mode]
    dtype = np.uint16 if mode == "I;16" else np.uint8
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    arr[10:20] = np.linspace(0, np.iinfo(dtype).max, 27).astype(dtype).reshape(
        (1, 27) + (1,) * (len(shape) - 2))
    path = str(tmp_path / "p.png")
    (Image.fromarray(arr) if mode == "I;16"
     else Image.fromarray(arr, mode)).save(path)
    np.testing.assert_array_equal(images.read_png(path), iio.imread(path))
    got, want = images.load_image(path), jprov._load_image(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the synthetic scene's own files, through the JAX writer
    ds = JaxSphere(n_frames=1, H=20, W=24)
    iio.imwrite(str(tmp_path / "s.png"), ds.images[0])
    np.testing.assert_array_equal(images.read_png(str(tmp_path / "s.png")),
                                  ds.images[0])


def test_png_kinds_that_raise(tmp_path):
    """What still raises: a 1-bit gray PNG (imageio reads booleans, which
    the JAX loader cannot scale), and a palette PNG without its PLTE
    chunk or with more than 256 entries (imageio raises on both)."""
    bits = np.random.default_rng(0).integers(0, 2, (4, 8, 1))
    _png(str(tmp_path / "b1.png"), bits, 1, 0)
    with pytest.raises(ValueError):
        jprov._load_image(str(tmp_path / "b1.png"))
    with pytest.raises(ValueError, match="1-bit gray PNG"):
        images.load_image(str(tmp_path / "b1.png"))
    rows = np.zeros((4, 4, 1), np.int64)
    _png(str(tmp_path / "pal.png"), rows, 8, 3)
    with pytest.raises(Exception):
        iio.imread(str(tmp_path / "pal.png"))
    with pytest.raises(ValueError, match="without a PLTE"):
        images.read_png(str(tmp_path / "pal.png"))
    _png(str(tmp_path / "big.png"), rows, 8, 3, palette=True,
         palette_bytes=bytes(257 * 3))
    with pytest.raises(ValueError, match="palette size"):
        iio.imread(str(tmp_path / "big.png"))
    with pytest.raises(ValueError, match="palette size"):
        images.read_png(str(tmp_path / "big.png"))


def test_jpeg_needs_pil(tmp_path, monkeypatch):
    """A JPEG loads without PIL (the port's own decoder), baseline and
    progressive, each equal to the JAX loader's imageio read."""
    arr = np.random.default_rng(0).integers(0, 256, (16, 20, 3), np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(path, quality=90)
    prog = str(tmp_path / "p.jpg")
    Image.fromarray(arr).save(prog, quality=90, progressive=True)
    want, want_prog = jprov._load_image(path), jprov._load_image(prog)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(images.load_image(path), want)
    np.testing.assert_array_equal(images.load_image(prog), want_prog)


@pytest.mark.parametrize("downscale", [1, 2])
def test_jpeg_scene_matches_jax(tmp_path, downscale):
    """A colmap scene of JPEG frames (written by PIL at quality 90, 4:2:0,
    an odd size) loads in the port as in the JAX loader, bit for bit."""
    path = str(tmp_path)
    JaxSphere(n_frames=4, H=35, W=43, seed=5).write_to_disk(path)
    with open(os.path.join(path, "transforms.json")) as f:
        meta = json.load(f)
    for fr in meta["frames"]:
        png = os.path.join(path, fr["file_path"])
        rgba = np.asarray(Image.open(png)).astype(np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        fr["file_path"] = fr["file_path"][:-4] + ".jpg"
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            os.path.join(path, fr["file_path"]), quality=90)
        os.remove(png)
    with open(os.path.join(path, "transforms.json"), "w") as f:
        json.dump(meta, f)
    ours = provider.NeRFDataset(path, downscale=downscale)
    theirs = jprov.NeRFDataset(path, downscale=downscale)
    assert ours.images.shape[-1] == 3
    _same(ours, theirs)


def test_write_png_round_trips(tmp_path):
    rng = np.random.default_rng(2)
    for c in (3, 4):
        img = rng.integers(0, 256, (7, 9, c), np.uint8)
        images.write_png(str(tmp_path / f"w{c}.png"), img)
        np.testing.assert_array_equal(iio.imread(str(tmp_path / f"w{c}.png")),
                                      img)


# ---------------------------------------------------------------------------
# Lanczos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(41, 37, 3), (41, 37, 4), (41, 37),
                                   (41, 37, 2)])
@pytest.mark.parametrize("size", [(18, 20), (12, 13), (17, 23), (37, 11),
                                  (60, 50)])
def test_lanczos_matches_pil(shape, size):
    rng = np.random.default_rng(sum(shape) + size[0])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if len(shape) == 3 and shape[2] in (2, 4):
        a = img[..., -1]
        a[rng.uniform(size=a.shape) < 0.3] = 0
        a[rng.uniform(size=a.shape) < 0.3] = 255
    want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
    np.testing.assert_array_equal(images.resize(img, *size), want)
    np.testing.assert_array_equal(images.resize(img, *size),
                                  jprov._resize(img, *size))


# ---------------------------------------------------------------------------
# the port's writer
# ---------------------------------------------------------------------------

def test_port_scene_files_load_in_both(tmp_path):
    ours = SyntheticSphereDataset(n_frames=4, H=30, W=26, seed=2)
    ours.write_to_disk(str(tmp_path / "port"))
    JaxSphere(n_frames=4, H=30, W=26, seed=2).write_to_disk(
        str(tmp_path / "jax"))
    with open(tmp_path / "port" / "transforms.json") as f:
        a = json.load(f)
    with open(tmp_path / "jax" / "transforms.json") as f:
        b = json.load(f)
    assert a == b
    for split in ("train", "all"):
        for kw in ({}, {"scale": 1.0, "normalize": False}):
            pj = jprov.NeRFDataset(str(tmp_path / "port"), split=split, **kw)
            jj = jprov.NeRFDataset(str(tmp_path / "jax"), split=split, **kw)
            _same(pj, jj)
            _same(provider.NeRFDataset(str(tmp_path / "port"), split=split,
                                       **kw), jj)
    # scale 1 without normalising gives the dataset's own poses back
    raw = provider.NeRFDataset(str(tmp_path / "port"), split="all",
                               scale=1.0, normalize=False)
    np.testing.assert_array_equal(raw.images, ours.images)
    np.testing.assert_allclose(raw.poses, ours.poses, rtol=0, atol=1e-6)

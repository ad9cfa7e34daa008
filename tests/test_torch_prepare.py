"""The capture-to-scene path of the port (``nerf_texture_tpu_torch.data.
prepare``) against the JAX package's ``data/prepare.py``: the sharpness
metric bit for bit against OpenCV (gray conversion, Laplacian, variance),
the same frames removed, byte-identical ``transforms.json`` files for
every COLMAP camera model, the same ffmpeg / colmap command lines (through
stand-in binaries that log them), the same raises without the binaries,
and the masked scenes (GrabCut, and the scribble segmenter's saved masks)
of ``prepare_scene(mask=True)`` and ``interactive=True``.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from nerf_texture_tpu.data import prepare as jprep
from nerf_texture_tpu_torch.data import prepare
from nerf_texture_tpu_torch.data.images import read_image

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape,dtype", [
    ((37, 45, 3), np.uint8), ((37, 45, 4), np.uint8), ((37, 45), np.uint8),
    ((30, 41, 3), np.uint16), ((30, 41, 4), np.uint16), ((30, 41), np.uint16),
    ((1, 7, 3), np.uint8), ((6, 1), np.uint8), ((1, 1, 3), np.uint16)])
def test_laplacian_variance_matches_opencv(shape, dtype):
    rng = np.random.default_rng(len(shape) + shape[0])
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    if shape[0] > 8:
        # a smooth half, where the Laplacian is small
        img[shape[0] // 2:] = img[shape[0] // 2, :1]
    assert prepare.laplacian_variance(img) == jprep.laplacian_variance(img)
    gray = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(prepare.laplacian(gray),
                                  cv2.Laplacian(gray, cv2.CV_64F))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_conversion_matches_opencv(dtype):
    """RGB2GRAY's fixed point over a wide random draw of colours with the
    extremes, with and without alpha (every 8-bit colour was checked
    once, 2^24 of them)."""
    top = np.iinfo(dtype).max
    rgb = np.random.default_rng(0).integers(0, top + 1, (700, 1001, 3))
    rgb[0, :8] = [[a, b, c] for a in (0, top) for b in (0, top)
                  for c in (0, top)]
    rgb = rgb.astype(dtype)
    got = prepare.rgb_to_gray(rgb)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, cv2.cvtColor(rgb,
                                                    cv2.COLOR_RGB2GRAY))
    rgba = np.concatenate([rgb[:64], rgb[:64, :, :1]], -1)
    np.testing.assert_array_equal(prepare.rgb_to_gray(rgba),
                                  cv2.cvtColor(rgba, cv2.COLOR_RGB2GRAY))


_JAX_RAISES = """
import numpy as np, cv2
from nerf_texture_tpu.data import prepare
for bad in (np.zeros((4, 5, 2), np.uint8), np.zeros((4, 5, 1), np.uint8),
            np.zeros((4, 5), bool)):
    try:
        prepare.laplacian_variance(bad)
        print("returned")
    except cv2.error:
        print("cv2.error")
"""


def test_laplacian_variance_inputs_that_raise():
    """What OpenCV refuses in the JAX function, the port refuses too: two
    channels, one channel as a 3-D array, booleans (1-bit gray).  The JAX
    side runs in a subprocess: a caught cv2.error in this process (beside
    jax) has crashed a later garbage collection."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _JAX_RAISES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.stdout.split() == ["cv2.error"] * 3, res.stdout + res.stderr
    for bad in (np.zeros((4, 5, 2), np.uint8), np.zeros((4, 5, 1), np.uint8),
                np.zeros((4, 5), bool)):
        with pytest.raises(ValueError):
            prepare.laplacian_variance(bad)


def _frames(path, n: int = 10):
    """n frames of a textured image as PNG, palette PNG, progressive and
    baseline JPEG, every other one box-blurred by a different width."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)
    for k in range(n):
        img = base.astype(np.float64)
        if k % 2:
            r = 1 + k // 2
            img = cv2.blur(img, (2 * r + 1, 2 * r + 1))
        img = np.clip(img + k, 0, 255).astype(np.uint8)
        kind = k % 4
        if kind == 0:
            iio.imwrite(os.path.join(path, f"{k:04d}.png"), img)
        elif kind == 1:
            Image.fromarray(img).quantize(64).save(
                os.path.join(path, f"{k:04d}.png"))
        elif kind == 2:
            Image.fromarray(img).save(os.path.join(path, f"{k:04d}.jpg"),
                                      quality=90, progressive=True)
        else:
            Image.fromarray(np.dstack([img, np.full(img.shape[:2], 200,
                                                    np.uint8)])).save(
                os.path.join(path, f"{k:04d}.png"))
    with open(os.path.join(path, "notes.txt"), "w") as f:
        f.write("not a frame\n")


@pytest.mark.parametrize("keep_ratio", [0.5, 0.8])
def test_remove_blurry_frames_removes_the_same_files(tmp_path, keep_ratio):
    _frames(str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    n_port = prepare.remove_blurry_frames(str(tmp_path / "a"), keep_ratio)
    n_jax = jprep.remove_blurry_frames(str(tmp_path / "b"), keep_ratio)
    left = sorted(os.listdir(tmp_path / "a"))
    assert n_port == n_jax > 0
    assert left == sorted(os.listdir(tmp_path / "b"))
    # the blurred ones go first
    gone = {f"{k:04d}" for k in range(10)} - {os.path.splitext(f)[0]
                                              for f in left}
    assert all(int(g) % 2 for g in gone)


# (model, its parameters) as COLMAP's cameras.txt writes them
CAMERAS = [
    ("SIMPLE_PINHOLE", "520.5 320 240"),
    ("PINHOLE", "500.25 510.75 319.5 239.5"),
    ("SIMPLE_RADIAL", "515 321.5 241 -0.0123"),
    ("RADIAL", "515 321.5 241 -0.0123 0.004"),
    ("OPENCV", "501 502.5 322 238 -0.01 0.002 0.0003 -0.0004"),
    ("OPENCV_FISHEYE", "401 402 320 240 0.01 0.02 0.03 0.04"),
    ("FULL_OPENCV", "501 503 321 239 -0.01 0.002 0.0003 -0.0004 0.1 0.2 "
     "0.3 0.4"),
]


def _colmap_text(path, model: str, params: str, n: int = 5):
    """A COLMAP text model of n images on a noisy orbit: cameras.txt with
    one camera, images.txt with each image's line and a 2D-points line."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(n)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                "# Number of cameras: 1\n"
                f"1 {model} 640 480 {params}\n")
    lines = ["# Image list with two lines of data per image:\n",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"]
    for k in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3) * 2
        lines.append(f"{k + 1} {' '.join(repr(float(v)) for v in q)} "
                     f"{' '.join(repr(float(v)) for v in t)} 1 "
                     f"frame_{k:03d}.png\n")
        lines.append(" ".join(f"{rng.uniform(0, 640):.2f} "
                              f"{rng.uniform(0, 480):.2f} {k}"
                              for _ in range(3)) + "\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("".join(lines))


@pytest.mark.parametrize("model,params", CAMERAS)
def test_colmap_to_transforms_writes_the_same_file(tmp_path, model, params):
    text = str(tmp_path / "colmap_text")
    _colmap_text(text, model, params)
    a = prepare.colmap_to_transforms(text, str(tmp_path / "images"),
                                     str(tmp_path / "ours.json"))
    b = jprep.colmap_to_transforms(text, str(tmp_path / "images"),
                                   str(tmp_path / "theirs.json"))
    assert a == b
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "theirs.json").read_bytes()
    assert len(a["frames"]) == 5 and a["frames"][0]["file_path"] == \
        os.path.join("images", "frame_000.png")
    for q in np.random.default_rng(1).normal(size=(4, 4)):
        np.testing.assert_array_equal(prepare._qvec2rotmat(q),
                                      jprep._qvec2rotmat(q))


_FAKE = """#!{python}
import os, shutil, sys
with open(os.environ["FAKE_LOG"], "a") as f:
    f.write(" ".join([os.path.basename(sys.argv[0])] + sys.argv[1:]) + "\\n")
args = sys.argv[1:]
if os.path.basename(sys.argv[0]) == "ffmpeg":
    out = os.path.dirname(args[-1])
    for name in sorted(os.listdir(os.environ["FAKE_FRAMES"])):
        shutil.copy(os.path.join(os.environ["FAKE_FRAMES"], name), out)
elif args[0] == "model_converter":
    out = args[args.index("--output_path") + 1]
    for name in ("cameras.txt", "images.txt"):
        shutil.copy(os.path.join(os.environ["FAKE_TEXT"], name), out)
"""


@pytest.fixture
def fake_binaries(tmp_path, monkeypatch):
    """ffmpeg and colmap stand-ins on PATH: each logs its command line to
    $FAKE_LOG; ffmpeg copies $FAKE_FRAMES into its output directory, and
    colmap's model_converter writes the text model of $FAKE_TEXT."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("ffmpeg", "colmap"):
        p = bin_dir / name
        p.write_text(_FAKE.format(python=sys.executable))
        p.chmod(0o755)
    frames, text = tmp_path / "frames", tmp_path / "text"
    _frames(str(frames))
    os.remove(frames / "notes.txt")
    _colmap_text(str(text), "OPENCV", CAMERAS[4][1])
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("FAKE_FRAMES", str(frames))
    monkeypatch.setenv("FAKE_TEXT", str(text))
    return tmp_path


def _log(tmp_path, monkeypatch, name):
    path = tmp_path / f"{name}.log"
    monkeypatch.setenv("FAKE_LOG", str(path))
    return path


def test_drivers_issue_the_same_commands(fake_binaries, monkeypatch):
    """extract_frames and run_colmap run the same command lines as the
    JAX drivers (paths aside) and return the same values; prepare_scene
    with mask=False writes a byte-identical transforms.json."""
    tmp = fake_binaries
    runs = {}
    for name, mod in (("port", prepare), ("jax", jprep)):
        log = _log(tmp, monkeypatch, name)
        root = tmp / name
        n = mod.extract_frames("capture.mp4", str(root / "raw"), fps=3)
        text = mod.run_colmap(str(root / "raw"), str(root),
                              matcher="exhaustive")
        out = mod.prepare_scene("capture.mp4", str(root / "scene"), fps=3,
                                keep_ratio=0.6, mask=False)
        runs[name] = (n, os.path.relpath(text, root), out,
                      log.read_text().replace(str(root), "<root>"),
                      (root / "scene" / "transforms.json").read_bytes(),
                      sorted(os.listdir(root / "scene" / "images_raw")))
    assert runs["port"] == runs["jax"]
    n, text, out, log, _, kept = runs["port"]
    assert n == 8 and text == "colmap_text" and len(kept) == 6
    assert "ffmpeg -y -i capture.mp4 -vf fps=3" in log
    assert "colmap exhaustive_matcher" in log
    assert "ImageReader.camera_model OPENCV" in log
    assert out["frames"][0]["file_path"].startswith("images_raw")


def test_drivers_raise_without_their_binaries(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    for mod in (prepare, jprep):
        with pytest.raises(RuntimeError, match="ffmpeg not found on PATH"):
            mod.extract_frames("v.mp4", str(tmp_path / "f"))
        with pytest.raises(RuntimeError, match="colmap not found on PATH"):
            mod.run_colmap(str(tmp_path / "f"), str(tmp_path / "ws"))


def _scene_outputs(root):
    """transforms.json's bytes and every image the scene's masks wrote,
    decoded."""
    out = {"transforms": (root / "transforms.json").read_bytes()}
    for sub in ("images", "images_masked", "masks"):
        if (root / sub).is_dir():
            out[sub] = {n: read_image(str(root / sub / n))
                        for n in sorted(os.listdir(root / sub))}
    return out


def _same_scene(port, jax):
    assert port.keys() == jax.keys()
    assert port["transforms"] == jax["transforms"]
    for sub in set(port) - {"transforms"}:
        assert port[sub].keys() == jax[sub].keys() and port[sub], sub
        for name, a in jax[sub].items():
            b = port[sub][name]
            assert a.shape == b.shape, (sub, name)
            assert (a == b).mean() >= 0.995, (sub, name)


def test_prepare_scene_with_masks_matches_jax(fake_binaries, monkeypatch):
    """prepare_scene's default (mask=True): GrabCut-masked RGBA frames in
    images/ (each >= 99.5% of the JAX file's values) and the same
    transforms.json, on the stand-in ffmpeg / colmap."""
    tmp = fake_binaries
    runs = {}
    for name, mod, kw in (("jax", jprep, {}), ("port", prepare,
                                               {"device": "cpu"})):
        _log(tmp, monkeypatch, name)
        root = tmp / name / "scene"
        cv2.setRNGSeed(0)
        out = mod.prepare_scene("capture.mp4", str(root), fps=3,
                                keep_ratio=0.6, **kw)
        assert out["frames"][0]["file_path"].startswith("images" + os.sep)
        runs[name] = _scene_outputs(root)
    assert len(runs["port"]["images"]) == 6
    assert all(v.shape[-1] == 4 for v in runs["port"]["images"].values())
    _same_scene(runs["port"], runs["jax"])


def test_prepare_scene_interactive_matches_jax(fake_binaries, monkeypatch):
    """interactive=True: the scribble server (here a stand-in that scripts
    a stroke, a segment, a propagation and a save, then stops as Ctrl-C
    does) writes images_masked/, which COLMAP then reads."""
    from nerf_texture_tpu.viewer import segment as jseg
    from nerf_texture_tpu_torch.viewer import segment as pseg

    def scripted(session, host="0.0.0.0", port=7870, block=True):
        session.add_stroke(0, [[20, 18], [30, 22]], 1, radius=3)
        session.add_stroke(0, [[1, 1], [50, 1]], 2, radius=2)
        session.segment(0)
        session.propagate_all(0)
        root = os.path.dirname(os.path.abspath(session.frame_dir))
        session.save(os.path.join(root, "masks"),
                     composite_dir=os.path.join(root, "images_masked"))
        raise KeyboardInterrupt

    monkeypatch.setattr(jseg, "serve_segmenter", scripted)
    monkeypatch.setattr(pseg, "serve_segmenter", scripted)
    tmp = fake_binaries
    runs = {}
    for name, mod, kw in (("jax", jprep, {}), ("port", prepare,
                                               {"device": "cpu"})):
        _log(tmp, monkeypatch, name)
        root = tmp / name / "scene"
        cv2.setRNGSeed(0)
        out = mod.prepare_scene("capture.mp4", str(root), fps=3,
                                keep_ratio=0.6, interactive=True, **kw)
        assert out["frames"][0]["file_path"].startswith("images_masked")
        runs[name] = _scene_outputs(root)
    assert len(runs["port"]["images_masked"]) == 6
    _same_scene(runs["port"], runs["jax"])

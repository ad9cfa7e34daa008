"""The foreground masks of the port (``data/segmenter.py``, ``ops/imgproc.py``,
``ops/draw.py``, ``ops/kmeans.py``, ``ops/grabcut.py``, ``ops/maxflow.py``'s
plain version, ``ops/optflow.py``) against cv2 and the JAX package's
``MaskSession``, on the CPU.

Frames are the synthetic sphere composited over a dark background, as
``tests/test_segmenter.py`` makes them (4 frames of 96x96), plus a session
at ``max_side=64`` (work_scale 1.5).  Bounds:

- the image operations and the strokes (points in the image, on its
  border and off it): bit for bit with cv2;
- k-means labels bit for bit with ``cv2.kmeans``; GrabCut's initial GMMs
  (``iterCount=0``) within 1e-9 relative of cv2's (measured: equal);
- one cut from injected models (GC_EVAL_FREEZE_MODEL): the mask on
  >= 99.9% of the pixels, the port's cut energy <= cv2's mask's x (1 +
  1e-9) under the port's weights (measured: 0 pixels differ); on a flat
  fixture where every straight cut ties, both cuts minimal (their
  energies within 1e-9; cv2's tie-break follows its trees, see
  ``ops/maxflow.py``, and the masks differ there); GC_EVAL for
  1 and 5 iterations: the same mask bound, models within 1e-6 relative
  where the masks agree (measured: equal);
- Farneback: |d flow| <= 1e-3 px on >= 99.9% of the pixels and <= 5e-2 px
  everywhere (measured: <= 5.3e-6 px); the warped masks on >= 99.9%;
- the whole session against JAX's on the same stroke maps and RNG seed
  (segment, propagate_all, a corrective segment, save): >= 99.5% of each
  frame's pixels (measured: equal), the JAX test's IoU bounds on the
  port's masks, the saved files decoding equal;
- ``segment_foreground`` / ``apply_masks``: >= 99.5% of each frame.
"""

import os

import cv2
import imageio.v3 as iio
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data import prepare as jprep
from nerf_texture_tpu.data.segmenter import MaskSession as JaxSession
from nerf_texture_tpu_torch.data import prepare
from nerf_texture_tpu_torch.data.images import read_image, write_png
from nerf_texture_tpu_torch.data.segmenter import MaskSession
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.ops import draw, imgproc, kmeans, maxflow
from nerf_texture_tpu_torch.ops import grabcut as gc
from nerf_texture_tpu_torch.ops.optflow import farneback

SESSION_MATCH = 0.995
CUT_MATCH = 0.999


def sphere_frames(n: int = 4, H: int = 96, W: int = 96):
    """The JAX test's frames (RGB over 24 gray) and alpha masks."""
    ds = SyntheticSphereDataset(n_frames=n, H=H, W=W)
    frames, gts = [], []
    for img in ds.images:
        rgb = img[..., :3].astype(np.float32)
        a = img[..., 3:].astype(np.float32) / 255.0
        frames.append((rgb * a + 24.0 * (1 - a)).astype(np.uint8))
        gts.append(a[..., 0] > 0.5)
    return frames, gts


@pytest.fixture(scope="module")
def frames():
    return sphere_frames()


def _iou(a, b):
    return (a & b).sum() / max(1, (a | b).sum())


def _rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# -- image operations ---------------------------------------------------

@pytest.mark.parametrize("src,dst", [((96, 96), (64, 64)),
                                     ((1080, 1920), (540, 960)),
                                     ((97, 131), (40, 50)),
                                     ((30, 45), (10, 15)),
                                     ((96, 96), (96, 96))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resizes_match_opencv(src, dst, channels):
    rng = np.random.default_rng(src[0] * channels)
    img = rng.integers(0, 256, src + ((3,) if channels == 3 else ()),
                       dtype=np.uint8)
    t = torch.from_numpy(img)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(
        imgproc.resize_nearest(t, size).numpy(),
        cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(
        imgproc.resize_area(t, size).numpy(),
        cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(imgproc.resize_linear(t, size).numpy(),
                                  cv2.resize(img, size))
    # nearest also upsamples (the session's masks back to full size)
    np.testing.assert_array_equal(
        imgproc.resize_nearest(torch.from_numpy(cv2.resize(
            img, size, interpolation=cv2.INTER_NEAREST)),
            (src[1], src[0])).numpy(),
        cv2.resize(cv2.resize(img, size, interpolation=cv2.INTER_NEAREST),
                   (src[1], src[0]), interpolation=cv2.INTER_NEAREST))


def test_remap_morphology_and_gray_match_opencv():
    rng = np.random.default_rng(3)
    H, W = 60, 70
    img = (rng.random((H, W)) > 0.4).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fx = rng.normal(0, 3, (H, W)).astype(np.float32)
    fy = rng.normal(0, 3, (H, W)).astype(np.float32)
    # ties at .5 (round half to even) and the border
    fx[::3, ::2] = np.round(fx[::3, ::2] * 2) / 2
    fy[1::3, ::2] = np.round(fy[1::3, ::2] * 2) / 2
    mx, my = xx + fx, yy + fy
    mx[0, :5] = [-0.5, -0.49, -0.51, W - 0.5, W - 0.51]
    np.testing.assert_array_equal(
        imgproc.remap_nearest(torch.from_numpy(img), torch.from_numpy(mx),
                              torch.from_numpy(my)).numpy(),
        cv2.remap(img, mx, my, cv2.INTER_NEAREST, borderValue=0))
    img[:, :4] = 1                       # a border the erosion keeps
    k = np.ones((5, 5), np.uint8)
    np.testing.assert_array_equal(imgproc.erode(torch.from_numpy(img), 5,
                                                2).numpy(),
                                  cv2.erode(img, k, iterations=2))
    np.testing.assert_array_equal(imgproc.dilate(torch.from_numpy(img), 5,
                                                 3).numpy(),
                                  cv2.dilate(img, k, iterations=3))
    rgb = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    gray = imgproc.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(gray, prepare.rgb_to_gray(rgb))
    np.testing.assert_array_equal(gray, cv2.cvtColor(rgb,
                                                     cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("radius", [2, 3, 6])
@pytest.mark.parametrize("n_points", [1, 2, 5])
def test_strokes_match_opencv(radius, n_points):
    """Polylines and filled one-point strokes with points in the image,
    on its border and off it, drawn over each other."""
    rng = np.random.default_rng(radius * 10 + n_points)
    H, W = 71, 93
    got = np.zeros((H, W), np.uint8)
    want = np.zeros((H, W), np.uint8)
    for t in range(40):
        off = 15 if t % 2 else 0
        pts = np.stack([rng.integers(-off, W + off, n_points),
                        rng.integers(-off, H + off, n_points)], 1)
        pts[0, t % 2] = 0 if t % 4 < 2 else (W - 1, H - 1)[t % 2]
        pts = pts.astype(np.int32)
        label = 1 + t % 2
        cv2.polylines(want, [pts], False, label, thickness=2 * radius)
        if n_points == 1:
            cv2.circle(want, tuple(int(v) for v in pts[0]), radius, label,
                       -1)
        draw.polyline(got, pts, label, 2 * radius)
        if n_points == 1:
            draw.circle(got, pts[0], radius, label)
    np.testing.assert_array_equal(got, want)


# -- GrabCut ------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_kmeans_matches_opencv(seed):
    """cv::kmeans with k-means++ centres: the labels bit for bit, on a
    sample that repeats colours (empty clusters appear and are repaired)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (3000, 3)).astype(np.float32)
    data[:2000] = rng.integers(20, 24, (2000, 3))
    data[2000:2100] = 200
    cv2.setRNGSeed(seed)
    _, labels, _ = cv2.kmeans(data, 5, None,
                              (cv2.TERM_CRITERIA_MAX_ITER, 10, 0), 1,
                              cv2.KMEANS_PP_CENTERS)
    got = kmeans.kmeans(torch.from_numpy(data), 5, kmeans.CvRNG(seed))
    np.testing.assert_array_equal(got.numpy(), labels[:, 0])


def _seed_mask(gt, H, W):
    mask = np.full((H, W), gc.GC_PR_BGD, np.uint8)
    mask[gt] = gc.GC_PR_FGD
    mask[:3] = gc.GC_BGD
    mask[H // 2 - 2:H // 2 + 2, W // 2 - 5:W // 2 + 5] = gc.GC_FGD
    return mask


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("mode", [gc.GC_INIT_WITH_RECT,
                                  gc.GC_INIT_WITH_MASK])
def test_gmm_initialisation_matches_opencv(frames, seed, mode):
    img = frames[0][1]
    H, W = img.shape[:2]
    mask = _seed_mask(frames[1][1], H, W)
    rect = (10, 8, 70, 60)
    bgd, fgd, m = np.zeros((1, 65)), np.zeros((1, 65)), mask.copy()
    cv2.setRNGSeed(seed)
    cv2.grabCut(img, m, rect, bgd, fgd, 0, mode)
    got, b, f = gc.grabcut(torch.from_numpy(img), torch.from_numpy(mask),
                           rect, None, None, 0, mode, kmeans.CvRNG(seed))
    assert _rel(b.numpy(), bgd) <= 1e-9 and _rel(f.numpy(), fgd) <= 1e-9
    np.testing.assert_array_equal(got.numpy(), m)


def _models(img, mask, seed=4):
    bgd, fgd = np.zeros((1, 65)), np.zeros((1, 65))
    cv2.setRNGSeed(seed)
    cv2.grabCut(img, mask.copy(), None, bgd, fgd, 0,
                cv2.GC_INIT_WITH_MASK)
    return bgd, fgd


def _graph(img, mask, bgd, fgd):
    t = torch.from_numpy(img)
    cap = gc.n_weights(t, gc.calc_beta(t))
    w = gc.t_weights(t, torch.from_numpy(mask),
                     gc.GMM(torch.from_numpy(bgd)),
                     gc.GMM(torch.from_numpy(fgd)))
    return cap, w


def _flat_fixture():
    """A flat image, one model on both sides (every probable pixel's net
    weight is 0), foreground held on the left column and background on
    the right: every straight vertical cut ties."""
    img = np.full((24, 40, 3), 90, np.uint8)
    mask = np.full((24, 40), gc.GC_PR_BGD, np.uint8)
    mask[:, 0] = gc.GC_FGD
    mask[:, -1] = gc.GC_BGD
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    bgd, _ = _models(src, np.where(np.arange(40) < 20, gc.GC_PR_FGD,
                                   gc.GC_PR_BGD)[None].repeat(24, 0)
                     .astype(np.uint8))
    return img, mask, bgd, bgd.copy()


@pytest.mark.parametrize("fixture", ["sphere", "flat"])
def test_frozen_model_cut_matches_opencv(frames, fixture):
    """One graph cut from injected models: the cut on >= 99.9% of the
    pixels and no more energy than cv2's (measured: equal masks)."""
    if fixture == "sphere":
        img = frames[0][0]
        mask = _seed_mask(frames[1][0], *img.shape[:2])
        bgd, fgd = _models(img, mask)
    else:
        img, mask, bgd, fgd = _flat_fixture()
    want = mask.copy()
    cv2.grabCut(img, want, None, bgd.copy(), fgd.copy(), 1,
                cv2.GC_EVAL_FREEZE_MODEL)
    got, _, _ = gc.grabcut(torch.from_numpy(img), torch.from_numpy(mask),
                           None, torch.from_numpy(bgd),
                           torch.from_numpy(fgd), 1,
                           gc.GC_EVAL_FREEZE_MODEL)
    got = got.numpy()
    cap, w = _graph(img, mask, bgd, fgd)
    e_port = maxflow.cut_energy(cap, w, torch.from_numpy(
        (got == gc.GC_FGD) | (got == gc.GC_PR_FGD)))
    e_cv2 = maxflow.cut_energy(cap, w, torch.from_numpy(
        (want == gc.GC_FGD) | (want == gc.GC_PR_FGD)))
    if fixture == "sphere":
        assert (got == want).mean() >= CUT_MATCH, int((got != want).sum())
        assert e_port <= e_cv2 * (1 + 1e-9)
    else:
        # every straight cut ties: cv2 keeps the one its trees met at
        # (Boykov-Kolmogorov's growth order; measured: columns 1-19 of 38
        # foreground), the port the smallest sink side (the background
        # column alone); both are minimal
        assert abs(e_port - e_cv2) <= 1e-9 * e_cv2
        assert (got[:, :-1] != gc.GC_PR_BGD).all()


@pytest.mark.parametrize("iters", [1, 5])
def test_eval_iterations_match_opencv(frames, iters):
    img = frames[0][2]
    mask = _seed_mask(frames[1][2], *img.shape[:2])
    bgd, fgd = _models(img, mask, seed=9)
    want, b, f = mask.copy(), bgd.copy(), fgd.copy()
    cv2.grabCut(img, want, None, b, f, iters, cv2.GC_EVAL)
    got, gb, gf = gc.grabcut(torch.from_numpy(img), torch.from_numpy(mask),
                             None, torch.from_numpy(bgd),
                             torch.from_numpy(fgd), iters, gc.GC_EVAL)
    assert (got.numpy() == want).mean() >= CUT_MATCH
    if (got.numpy() == want).all():
        assert _rel(gb.numpy(), b) <= 1e-6 and _rel(gf.numpy(), f) <= 1e-6


def test_min_cut_plain_version_records_its_work():
    img = np.random.default_rng(0).integers(0, 256, (12, 17, 3),
                                            dtype=np.uint8)
    t = torch.from_numpy(img)
    cap = gc.n_weights(t, gc.calc_beta(t))
    w = torch.from_numpy(np.random.default_rng(1).normal(0, 60, (12, 17)))
    s0 = maxflow.min_cut.sweeps
    src = maxflow.min_cut(cap, w)
    ref, stats = maxflow.min_cut_reference(cap, w)
    assert torch.equal(src, ref) and maxflow.min_cut.last_stats == stats
    assert maxflow.min_cut.sweeps == s0 + stats["sweeps"]
    # no single node moves across and lowers the energy
    e = maxflow.cut_energy(cap, w, src)
    for y, x in [(0, 0), (5, 8), (11, 16)]:
        flip = src.clone()
        flip[y, x] = ~flip[y, x]
        assert maxflow.cut_energy(cap, w, flip) >= e - 1e-9


# -- Farneback ----------------------------------------------------------

def _textured(H, W):
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(0)
    base = gaussian_filter(rng.random((H, W)) * 255, 3)
    base = (base - base.min()) / (base.max() - base.min()) * 255
    return (base.astype(np.uint8),
            shift(base, (1.7, -2.3), mode="nearest").astype(np.uint8))


@pytest.mark.parametrize("case", ["sphere96", "textured240x160"])
def test_farneback_matches_opencv(frames, case):
    if case == "sphere96":
        g = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames[0]]
        dst, src = g[1], g[0]
    else:
        dst, src = _textured(160, 240)          # 3 pyramid levels
    want = cv2.calcOpticalFlowFarneback(dst, src, None, 0.5, 3, 21, 3, 5,
                                        1.2, 0)
    got = farneback(torch.from_numpy(dst), torch.from_numpy(src)).numpy()
    d = np.abs(got - want).max(-1)
    assert (d <= 1e-3).mean() >= 0.999 and d.max() <= 5e-2, d.max()
    H, W = dst.shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    m = (np.hypot(yy - H / 2, xx - W / 2) < H / 3).astype(np.uint8)
    warp_cv = cv2.remap(m, xx + want[..., 0], yy + want[..., 1],
                        cv2.INTER_NEAREST, borderValue=0)
    warp = imgproc.remap_nearest(torch.from_numpy(m),
                                 torch.from_numpy(xx + got[..., 0]),
                                 torch.from_numpy(yy + got[..., 1])).numpy()
    assert (warp == warp_cv).mean() >= 0.999


# -- the session ----------------------------------------------------------

@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory, frames):
    root = tmp_path_factory.mktemp("segframes")
    for i, f in enumerate(frames[0]):
        iio.imwrite(os.path.join(root, f"{i:04d}.png"), f)
    return str(root)


@pytest.mark.parametrize("max_side", [960, 64])
def test_session_matches_jax(frames, frame_dir, tmp_path, max_side):
    """The JAX test's scribbles, segment(0), propagate_all(0), a
    corrective segment(1) and save, against the JAX session on the same
    stroke maps with the same RNG seed."""
    gts = frames[1]
    seed = 11
    cv2.setRNGSeed(seed)
    js = JaxSession(frame_dir, max_side=max_side)
    ps = MaskSession(frame_dir, max_side=max_side, device="cpu", seed=seed)
    assert ps.work_scale == js.work_scale == (1.0 if max_side == 960
                                              else 1.5)
    ys, xs = np.nonzero(gts[0])
    cy, cx = int(ys.mean()), int(xs.mean())
    js.add_stroke(0, [[cx - 10, cy], [cx + 10, cy]], label=1, radius=3)
    js.add_stroke(0, [[2, 2], [93, 2]], label=2, radius=2)
    js.add_stroke(0, [[2, 93], [93, 93]], label=2, radius=2)
    ps.strokes[0][:] = js.strokes[0]

    def agree(i):
        assert (ps.masks[i] == js.masks[i]).mean() >= SESSION_MATCH, i

    js.segment(0)
    ps.segment(0)
    agree(0)
    assert _iou(ps.masks[0], gts[0]) > 0.7
    assert js.propagate_all(0) == ps.propagate_all(0) == 3
    for i in range(1, 4):
        agree(i)
        assert _iou(ps.masks[i], gts[i]) > 0.6
    js.add_stroke(1, [[2, 2], [40, 2]], label=2, radius=2)
    ps.strokes[1][:] = js.strokes[1]
    js.segment(1)
    ps.segment(1)
    agree(1)
    assert _iou(ps.masks[1], gts[1]) > 0.6
    assert set(ps.timings) == {"resize", "flow", "kmeans", "gmm", "cut"}
    out = {}
    for name, s in (("jax", js), ("port", ps)):
        root = tmp_path / name
        assert s.save(str(root / "masks"),
                      composite_dir=str(root / "images_masked")) == 4
        out[name] = root
    for sub in ("masks", "images_masked"):
        names = sorted(os.listdir(out["jax"] / sub))
        assert names == sorted(os.listdir(out["port"] / sub))
        for n in names:
            a = iio.imread(out["jax"] / sub / n)
            b = read_image(str(out["port"] / sub / n))
            assert a.shape == b.shape and (a == b).mean() >= SESSION_MATCH


def test_session_stroke_rasteriser_matches_jax(frame_dir):
    """add_stroke and clear_strokes draw what the JAX session draws."""
    js = JaxSession(frame_dir)
    ps = MaskSession(frame_dir, device="cpu")
    for pts, label, radius in (([[40, 50], [60, 52], [61, 70]], 1, 6),
                               ([[3, 3]], 2, 4), ([[95, 0], [0, 95]], 2, 2)):
        js.add_stroke(2, pts, label, radius)
        ps.add_stroke(2, pts, label, radius)
    np.testing.assert_array_equal(ps.strokes[2], js.strokes[2])
    ps.clear_strokes(2)
    assert not ps.strokes[2].any()


def test_segment_foreground_and_apply_masks_match_jax(frames, frame_dir,
                                                      tmp_path):
    img = frames[0][3]
    cv2.setRNGSeed(0)
    want = jprep.segment_foreground(img)
    got = prepare.segment_foreground(img, device="cpu")
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert (got == want).mean() >= SESSION_MATCH
    cv2.setRNGSeed(0)
    jprep.apply_masks(frame_dir, str(tmp_path / "jax"))
    prepare.apply_masks(frame_dir, str(tmp_path / "port"), device="cpu")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for n in names:
        a = iio.imread(tmp_path / "jax" / n)
        b = read_image(str(tmp_path / "port" / n))
        assert a.shape == b.shape == (96, 96, 4)
        assert (a[..., 3] == b[..., 3]).mean() >= SESSION_MATCH
        np.testing.assert_array_equal(a[..., :3], b[..., :3])


def test_write_png_gray_decodes_as_imageio_reads_jax_mask(tmp_path):
    m = (np.random.default_rng(2).random((37, 53)) > 0.5).astype(
        np.uint8) * 255
    iio.imwrite(tmp_path / "jax.png", m)
    write_png(str(tmp_path / "port.png"), m)
    np.testing.assert_array_equal(iio.imread(tmp_path / "port.png"),
                                  iio.imread(tmp_path / "jax.png"))
    np.testing.assert_array_equal(read_image(str(tmp_path / "port.png")), m)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), m.astype(np.uint16))

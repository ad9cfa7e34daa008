"""The curved training's random draws in the port against the JAX
package's, as distributions (the two draw from different generators, so
no value can match): a training step's pixel indices, march jitter,
per-pixel background, feature noise and clustering level
(``train/curved_trainer.py::sample_curved_batch`` against the keys the
JAX package's ``curved_train_step`` splits, ``tests/jax_draws.py::
curved_batch``, with ``nerf_texture_tpu/data/rays.py::
sample_ray_indices``), the frame pick, and the sparse refresh's cell
jitter (``ops/occupancy.py::sparse_draws`` against ``curved_grid_noise``),
and the seeded init (``train/curved_trainer.py::init_state`` from a
``torch.Generator`` against the JAX package's from a ``PRNGKey``): every
leaf's shape and its values' law.

At the bench's curved configs (``chip_smoke.py``'s CURVED_TRAIN and
CURVED_RENDER, ``MeshFieldConfig()``), 40x40 frames.  Each sample of
either package is tested against its law (uniform or normal, on the
stated range) and the two samples against each other, by chi-square or
Kolmogorov-Smirnov at p >= 1e-3 (seeded: the statistics are fixed
numbers; 1e-3 leaves room for any seed a later edit picks), and the
counts (rows, duplicates among a step's pixels: both draw with
replacement) within 5 standard deviations of their expectation.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import chip_smoke as smoke
import test_torch_curved_train as C
from jax_draws import curved_batch, curved_grid_noise
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

H = W = 40
FRAMES = 8
STEPS = 24          # draws of each package
P_MIN = 1e-3


@pytest.fixture(scope="module")
def draws():
    tcfg = tct.CurvedTrainConfig(**smoke.CURVED_TRAIN)
    rcfg = RenderConfig(**smoke.CURVED_RENDER)
    fcfg = MeshFieldConfig()
    port, ref = [], []
    g = torch.Generator().manual_seed(7)
    levels = torch.randint(0, fcfg.num_levels, (STEPS,), generator=g)
    rng = np.random.default_rng(0)          # JAX's trainer's frame picks
    key = jax.random.PRNGKey(7)
    for i in range(STEPS):
        port.append(tct.sample_curved_batch(
            g, num_frames=FRAMES, H=H, W=W, tcfg=tcfg, rcfg=rcfg, fcfg=fcfg,
            level=int(levels[i])))
        key, k = jax.random.split(key)
        ref.append(curved_batch(k, rng.integers(0, FRAMES), tcfg, rcfg, H,
                                W, fcfg))
    return tcfg, rcfg, fcfg, port, ref


def _cat(batches, name):
    return torch.stack([torch.as_tensor(getattr(b, name)) for b in batches]) \
        .double().numpy()


def _uniform_ints(x, n):
    """chi-square p-value of integers x against uniform on [0, n)."""
    assert x.min() >= 0 and x.max() < n
    return stats.chisquare(np.bincount(x.astype(np.int64), minlength=n)).pvalue


def _same_ints(a, b, n):
    ca = np.bincount(a.astype(np.int64), minlength=n)
    cb = np.bincount(b.astype(np.int64), minlength=n)
    return stats.chi2_contingency(np.stack([ca, cb]) + 0.0).pvalue


def test_pixels_frames_and_levels(draws):
    tcfg, _, fcfg, port, ref = draws
    for name, n in (("inds", H * W), ("frame", FRAMES),
                    ("level", fcfg.num_levels)):
        a, b = _cat(port, name).ravel(), _cat(ref, name).ravel()
        assert _uniform_ints(a, n) >= P_MIN, name
        assert _uniform_ints(b, n) >= P_MIN, name
        assert _same_ints(a, b, n) >= P_MIN, name
    # with replacement in both: a step's repeated pixels
    n, m = tcfg.num_rays, H * W
    expect = n - m * (1 - (1 - 1 / m) ** n)
    for batches in (port, ref):
        dup = np.mean([n - len(np.unique(b.inds.numpy())) for b in batches])
        assert abs(dup - expect) <= 5 * np.sqrt(expect / STEPS), dup


def test_jitter_background_and_noise(draws):
    tcfg, rcfg, fcfg, port, ref = draws
    for name in ("u", "bg"):
        a, b = _cat(port, name).ravel(), _cat(ref, name).ravel()
        assert 0 <= a.min() and a.max() < 1 and 0 <= b.min() and b.max() < 1
        assert stats.kstest(a, "uniform").pvalue >= P_MIN, name
        assert stats.kstest(b, "uniform").pvalue >= P_MIN, name
        assert stats.ks_2samp(a, b).pvalue >= P_MIN, name
    shape = (tct.noise_rows(rcfg, tcfg.num_rays), fcfg.encoder_f_out_dim)
    assert tuple(port[0].noise.shape) == tuple(ref[0].noise.shape) == shape
    a = _cat(port[:2], "noise").ravel()[::97]
    b = _cat(ref[:2], "noise").ravel()[::97]
    assert stats.kstest(a, "norm").pvalue >= P_MIN
    assert stats.kstest(b, "norm").pvalue >= P_MIN
    assert stats.ks_2samp(a, b).pvalue >= P_MIN


def test_refresh_jitter(draws):
    _, rcfg, _, _, _ = draws
    n, gs = 300000, rcfg.grid_size
    half = 1.0 / gs
    a = tocc.sparse_draws(torch.Generator().manual_seed(3), n, grid_size=gs,
                          cascades=1, bound=rcfg.bound)[0].double().numpy()
    b = curved_grid_noise(jax.random.PRNGKey(3), n, gs).astype(np.float64)
    assert a.shape == b.shape == (n, 3)
    for x in (a, b):
        assert -half <= x.min() and x.max() < half
    a, b = a.ravel()[::7], b.ravel()[::7]
    u = dict(args=(-half, 2 * half))
    assert stats.kstest(a, "uniform", **u).pvalue >= P_MIN
    assert stats.kstest(b, "uniform", **u).pvalue >= P_MIN
    assert stats.ks_2samp(a, b).pvalue >= P_MIN


def test_init_matches_jax_distributions():
    """The bench's curved init from a seed: the same leaves and shapes as
    JAX's, constant leaves equal, every other leaf's values from the
    same law (two-sample Kolmogorov-Smirnov, at most 200,000 values a
    leaf)."""
    fcfg = dict(light_model="SH")
    want = jct.init_state(
        jax.random.PRNGKey(7),
        jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(), **fcfg),
        jr.RenderConfig(**smoke.CURVED_RENDER),
        jct.CurvedTrainConfig(**smoke.CURVED_TRAIN), FRAMES)
    got = tct.init_state(
        torch.Generator().manual_seed(7),
        tcf.CurvedFieldConfig(field=MeshFieldConfig(), **fcfg),
        RenderConfig(**smoke.CURVED_RENDER),
        tct.CurvedTrainConfig(**smoke.CURVED_TRAIN), FRAMES)
    fw = C._flat(jax.tree.map(np.asarray, want.params))
    fg = C._flat(got.params)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert fw[k].shape == fg[k].shape, k
        a = np.asarray(fw[k], np.float64).ravel()
        b = np.asarray(fg[k], np.float64).ravel()
        if a.std() == 0 and b.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=str(k))
            continue
        step = max(1, a.size // 200000)
        assert stats.ks_2samp(a[::step], b[::step]).pvalue >= P_MIN, k

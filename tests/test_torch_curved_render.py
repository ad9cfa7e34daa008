"""The curved serving path of the PyTorch port vs the JAX package: the
sparse grid refresh, ``survivor_pool``, and ``CurvedTrainer`` frames --
the live proxy render and the ``parity=True`` pool render -- with JAX's
params and grid converted.

Small width: the field, model and render configs of
``tests/test_curved_trainer.py`` with the single-round proxy
(``proxy_samples=0``, the bench setting) and a ray chunk that splits a
48x48 frame into several chunks; ``make_icosphere(2, 0.5)``.  The JAX
frame reaches ``proxy_select_cdf`` in interpret mode, its CPU default.

Tolerances, each with its reason:
- the grid refresh with JAX's jitter: occupancy masks exact, densities
  within 1e-5 (relative) for >= 99% of cells (bf16 rows and activations
  can round to a neighbouring value after a last-bit difference);
- survivor_pool: exact (integer bookkeeping over the same weights);
- frames: PSNR >= 45 dB, max abs error <= 5e-2, live pixels differing
  <= 0.5% -- the NGP slice's bounds (bf16 rounding of table products and
  MLP activations; a prepass hit test on a cell border can flip a
  block).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models.curved_field import (
    CurvedFieldConfig as JaxCurvedFieldConfig)
from nerf_texture_tpu.models.mesh_field import (
    MeshFieldConfig as JaxMeshFieldConfig)
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.render import compact as jcompact
from nerf_texture_tpu.render.renderer import RenderConfig as JaxRenderConfig
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import mesh_field
from nerf_texture_tpu_torch.models.curved_field import CurvedFieldConfig
from nerf_texture_tpu_torch.models.mesh_field import MeshFieldConfig
from nerf_texture_tpu_torch.ops.marching import MarchResult
from nerf_texture_tpu_torch.render import compact as tcompact
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
HW = 48


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _configs(change=None):
    rj = JaxRenderConfig(**dict(RENDER, **(change or {})))
    return (JaxCurvedFieldConfig(field=JaxMeshFieldConfig(**FIELD), **MODEL),
            CurvedFieldConfig(field=MeshFieldConfig(**FIELD), **MODEL),
            rj, RenderConfig(**dataclasses.asdict(rj)))


def _scaled(params):
    """JAX params (numpy) with features that matter: the encoder's mean
    lanes x 1e4 (U(-1e-4, 1e-4) at init) and the phi grid x 1e3."""
    p = jax.tree.map(np.asarray, params)
    rw = JaxMeshFieldConfig(**FIELD).feature_spec.row_width
    enc = p["field"]["encoder"].copy()
    enc[:, :rw] *= 1e4
    p["field"]["encoder"] = enc
    p["field"]["normal"]["phi_grid"] = p["field"]["normal"]["phi_grid"] * 1e3
    return p


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: beside pytest-xdist's other
    workers and JAX's thread pools a full torch pool makes every small op
    wait on the busy cores (as in tests/test_torch_checkpoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainers():
    """A JAX CurvedTrainer after one grid refresh, and the port's
    CurvedTrainer holding its params (EMA = params) and grid."""
    cj, ct, rj, rt = _configs()
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(
        jax_icosphere(2, radius=0.5))), cj, rj, jct.CurvedTrainConfig(),
        key=jax.random.PRNGKey(0))
    p = _scaled(tj.state.params)
    pj = jax.tree.map(jnp.asarray, p)
    tj.state = tj.state._replace(params=pj, ema_params=pj)
    tj.initialize_states(1)
    occ = tj.state.occ
    ds_t = tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tt = tct.CurvedTrainer(ds_t, mesh_field.make_state(MeshProjector(
        make_icosphere(2, radius=0.5), device="cpu")), ct, rt,
        tct.CurvedTrainConfig(), device="cpu")
    tt.state.params = params_from_jax(p, device="cpu")
    tt.state.ema_params = tt.state.params
    tt.state.occ = occupancy_from_jax(occ.density, occ.occ,
                                      occ.mean_density, occ.iter_density,
                                      device="cpu")
    return tj, tt


def _assert_frames_close(got, want):
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    assert img_t.shape == (HW, HW, 3)
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.05 < live_j.mean() < 0.9
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    # the frame has structure, not one flat colour
    assert img_j[live_j].std() > 1e-2


@pytest.mark.parametrize("parity", [False, True])
def test_render_frame_matches_jax(trainers, parity):
    tj, tt = trainers
    pose = np.asarray(tj.dataset.poses[1])
    want = tj.render_frame(pose, use_ema=True, parity=parity)
    got = tt.render_frame(pose, use_ema=True, parity=parity)
    assert got["chunks"] >= 2 and 0 < got["live"] < HW * HW
    _assert_frames_close(got, want)


@pytest.mark.parametrize("variant", ["per_ray_live", "per_ray_pool",
                                     "dense_pool"])
def test_render_frame_variants_match_jax(trainers, variant):
    """Without the anchor table each ray anchors once by kNN (seeded at
    its first survivor, or its first marched sample); without a sample
    pool the field runs on the dense [N, K] march."""
    tj, tt = trainers
    pose = np.asarray(tj.dataset.poses[3])
    rcfg_j, rcfg_t = tj.rcfg, tt.rcfg
    try:
        if variant == "dense_pool":
            tj.rcfg = dataclasses.replace(rcfg_j, pool_mean_samples=0)
            tt.rcfg = dataclasses.replace(rcfg_t, pool_mean_samples=0)
        else:
            tj.anchor_cache = tt.anchor_cache = False
        parity = variant != "per_ray_live"
        want = tj.render_frame(pose, parity=parity)
        got = tt.render_frame(pose, parity=parity)
    finally:
        tj.rcfg, tt.rcfg = rcfg_j, rcfg_t
        tj.anchor_cache = tt.anchor_cache = True
    _assert_frames_close(got, want)


def test_eval_psnr_matches_jax(trainers):
    tj, tt = trainers
    for parity in (False, True):
        a = tt.eval_psnr([0, 2], parity=parity)
        b = tj.eval_psnr([0, 2], parity=parity)
        assert abs(a - b) < 0.05, (parity, a, b)


def test_grid_refresh_matches_jax_with_its_jitter(trainers):
    tj, tt = trainers
    cj, ct, rj, rt = _configs()
    tab_j = tj._anchor_table()
    near = tj._get_near_cells()
    key = jax.random.PRNGKey(3)
    # the JAX refresh splits its key once per chunk of 262,144 cells
    assert len(near) < 262144
    _, k = jax.random.split(key)
    half = 1.0 / rj.grid_size
    noise = np.array(jax.random.uniform(k, (262144, 3), minval=-half,
                                        maxval=half))[:len(near)]
    st_j = jct.curved_grid_step(
        tj.state._replace(occ=jocc.create(rj.grid_size, 1)), tj.field_state,
        key, ccfg=cj, rcfg=rj, near_cells=near, anchor_tab=tab_j,
        rt=tj.runtime)
    st_t = dataclasses.replace(
        tt.state, occ=tct.occ_mod.create(rt.grid_size, 1, device="cpu"))
    st_t = tct.curved_grid_step(
        st_t, tt.field_state, [torch.from_numpy(noise)], ccfg=ct, rcfg=rt,
        near_cells=near, anchor_tab=torch.from_numpy(np.array(tab_j)),
        rt=tt.runtime)
    d_t, d_j = _np(st_t.occ.density), np.asarray(st_j.occ.density)
    np.testing.assert_array_equal(_np(st_t.occ.occ), np.asarray(st_j.occ.occ))
    assert 0 < _np(st_t.occ.occ).sum() < rt.grid_size ** 3
    close = np.abs(d_t - d_j) <= 1e-5 * np.maximum(np.abs(d_j), 1.0)
    assert close.mean() >= 0.99
    np.testing.assert_allclose(float(st_t.occ.mean_density),
                               float(st_j.occ.mean_density), rtol=1e-4)
    # the port's own refresh (its own jitter) takes the same path
    assert np.array_equal(np.sort(tt._get_near_cells().numpy()),
                          np.sort(near))


def test_refresh_decays_at_095_like_jax(trainers):
    """The curved refresh ignores TrainConfig.grid_decay (the JAX
    function never passes it): old densities decay by 0.95."""
    tj, tt = trainers
    _, ct, _, rt = _configs()
    H = rt.grid_size
    dens = torch.full((1, H ** 3), 100.0)
    occ = tct.occ_mod.OccupancyGrid(
        dens, (dens[0] > 0).to(torch.uint8), dens.mean(),
        torch.zeros((), dtype=torch.int32))
    st = dataclasses.replace(tt.state, occ=occ)
    far = torch.tensor([0])                   # a corner cell: sigma 0
    st = tct.curved_grid_step(st, tt.field_state, [torch.zeros((1, 3))],
                              ccfg=ct, rcfg=rt, near_cells=far,
                              anchor_tab=tt._anchor_table())
    assert float(st.occ.density[0, 0]) == pytest.approx(95.0)


def _pool_inputs(seed):
    rng = np.random.default_rng(seed)
    N, K = 40, 12
    counts = rng.integers(0, K + 1, N)
    counts[:3] = [0, K, 1]
    ts = np.sort(rng.uniform(0.5, 2.5, (N, K)), -1).astype(np.float32)
    mask = np.arange(K)[None] < counts[:, None]
    dts = np.full((N, K), 0.05, np.float32)
    return N, K, counts, ts * mask, dts * mask, mask


@pytest.mark.parametrize("seed,cap,budget_per_ray", [(0, 4, 8), (1, 2, 12),
                                                     (2, 3, 3)])
def test_survivor_pool_matches_jax(seed, cap, budget_per_ray):
    N, K, counts, ts, dts, mask = _pool_inputs(seed)
    from nerf_texture_tpu.ops.marching import MarchResult as JaxMarch
    flat_j = jcompact.flatten_samples(
        JaxMarch(ts=jnp.asarray(ts), dts=jnp.asarray(dts),
                 mask=jnp.asarray(mask), counts=jnp.asarray(counts,
                                                            jnp.int32)),
        N * budget_per_ray)
    flat_t = tcompact.flatten_samples(
        MarchResult(ts=torch.from_numpy(ts), dts=torch.from_numpy(dts),
                    mask=torch.from_numpy(mask),
                    counts=torch.from_numpy(counts)), N * budget_per_ray)
    M = N * budget_per_ray
    rng = np.random.default_rng(10 + seed)
    # weights on a coarse lattice (ties at the cap), some below w_eps
    w = (rng.integers(0, 6, M) * 0.05).astype(np.float32)
    trans = rng.uniform(0, 1, M).astype(np.float32)
    trans[::7] = 0.0
    for tr_j, tr_t in ((None, None),
                       (jnp.asarray(trans), torch.from_numpy(trans))):
        sj = jcompact.survivor_pool(flat_j, jnp.asarray(w), N, cap=cap,
                                    w_eps=1e-4, trans=tr_j)
        st = tcompact.survivor_pool(flat_t, torch.from_numpy(w), N,
                                    cap=cap, w_eps=1e-4, trans=tr_t)
        for name in ("idx", "ray_id", "valid", "offsets"):
            np.testing.assert_array_equal(_np(getattr(st, name)),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=name)
        assert int(st.offsets[-1]) > 0


def test_unported_paths_raise(trainers):
    tj, tt = trainers
    pose = tt.dataset.poses[0]
    _, ct, _, rt = _configs()
    # a refresh without the anchor table runs the exact projection now;
    # a 'shape' import needs the canvas images of a 'field' import
    with pytest.raises(ValueError, match="load_field"):
        tct.curved_grid_step(tt.state, tt.field_state, [torch.zeros((1, 3))],
                             ccfg=ct, rcfg=rt, near_cells=[0], mode="shape")
    # deferred shading is ported for the baked frame
    # (tests/test_torch_deferred.py); the live frame ignores it, as in JAX
    rcfg = tt.rcfg
    live = tt.render_frame(pose)
    tt.rcfg = dataclasses.replace(rcfg, deferred=True)
    try:
        deferred = tt.render_frame(pose)
    finally:
        tt.rcfg = rcfg
    assert deferred["live"] > 0
    for k in ("image", "depth", "weights_sum"):
        assert torch.equal(deferred[k], live[k]), k
    tcfg = tt.tcfg
    # progressive levels are ported: with the hash encoder, as in JAX, the
    # schedule has no level to advance
    tt.tcfg = dataclasses.replace(tcfg, iters_per_level=100)
    try:
        tt._maybe_update_level(100)
        assert tt.fea_level == 0 and not tt.update_field_level()
    finally:
        tt.tcfg = tcfg
    # the visual modes are ported: the coarse-normal frame is JAX's
    tt.visual_mode = tj.visual_mode = "Nc"
    try:
        _assert_frames_close(tt.render_frame(pose), tj.render_frame(
            np.asarray(pose)))
    finally:
        tt.visual_mode = tj.visual_mode = "RGB"

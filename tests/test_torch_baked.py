"""The baked atlas of the PyTorch port vs the JAX package: the bake plan,
the extended anchor table and its frames, the atlas itself, the bilinear
lookup, ``forward_baked``, and ``CurvedTrainer.render_frame(baked=True)``
with JAX's params, grid and anchor table converted.

Small width: the configs of ``tests/test_torch_curved_render.py`` (the
field, model and render configs of ``tests/test_curved_trainer.py``,
``proxy_samples=0``, ``make_icosphere(2, 0.5)``, 48x48 frames in several
chunks) with the bench's baked settings (``prepass_block=8``,
``prepass_tau_cull=0.1``, ``proxy_refined=16``).  The JAX frame reaches
``proxy_select_cdf`` in interpret mode, its CPU default.

Tolerances, each with its reason:
- plan_bake, extend_anchor_table, anchor_frames_ext: exact (host numpy
  and gathers of the same rows);
- the atlas: each entry within one bf16 ulp of its row's largest entry
  (the encode's f32 sums may differ in the last bit, and then the bf16
  rounding of the packed row by one ulp), but for <= 1e-5 of the entries
  (measured 32 of 33.5M): XLA rounds the texel positions p0 + f t + f b
  with its own fused multiply-adds, and a texel on a brick face can then
  land in the neighbouring brick, whose copy of the shared lattice corner
  holds another value;
- lookup, forward_baked: the field bounds of
  tests/test_torch_curved_field.py (features 2e-2 of the max, sigma
  rtol + atol 1e-2, colours 1e-2; bf16 activations);
- the baked frame: PSNR >= 45 dB and max abs <= 5e-2 (the slices' frame
  bounds).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.geometry.projector import (
    anchor_frames_from_table as jax_frames_from_table)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.render import baked as jbaked
from nerf_texture_tpu.render.renderer import RenderConfig as JaxRenderConfig
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import (
    MeshProjector, anchor_frames_from_table)
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field
from nerf_texture_tpu_torch.render import baked as tbaked
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0, prepass_block=8, prepass_tau_cull=0.1,
              proxy_refined=16)
HW = 48


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


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
    """A JAX CurvedTrainer after one grid refresh over scaled params
    (encoder mean lanes x 1e4, phi grid x 1e3, so the features matter),
    its bake, and the port's CurvedTrainer holding the same params, grid
    and anchor table."""
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=mesh_field.MeshFieldConfig(**FIELD),
                               **MODEL)
    rj = JaxRenderConfig(**RENDER)
    rt = RenderConfig(**dataclasses.asdict(rj))
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(
        jax_icosphere(2, radius=0.5))), cj, rj, jct.CurvedTrainConfig(),
        key=jax.random.PRNGKey(0))
    p = jax.tree.map(np.array, tj.state.params)
    p["field"]["encoder"][:, :cj.field.feature_spec.row_width] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    pj = jax.tree.map(jnp.asarray, p)
    tj.state = tj.state._replace(params=pj, ema_params=pj)
    tj.initialize_states(1)
    bake_j, ext_j = tj.bake_atlas()
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=HW, W=HW),
        mesh_field.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                            device="cpu")),
        ct, rt, tct.CurvedTrainConfig(), device="cpu")
    tt.state = tct.init_curved_state(tt.generator, ct, rt, tt.tcfg,
                                     params=params_from_jax(p, device="cpu"))
    occ = tj.state.occ
    tt.state.occ = occupancy_from_jax(occ.density, occ.occ,
                                      occ.mean_density, occ.iter_density,
                                      device="cpu")
    tab = torch.from_numpy(np.array(tj._anchor_table()))
    tt._anchor_tab = (tt.field_state.projector, True, tab)
    return dict(tj=tj, tt=tt, cj=cj, ct=ct, bake_j=bake_j, ext_j=ext_j,
                tab=tab)


def _port_bake(bake_j) -> tbaked.BakedAtlas:
    """JAX's atlas converted, so that only the lookup differs."""
    return tbaked.BakedAtlas(
        tile_of_cell=_t(bake_j.tile_of_cell),
        atlas=_t(bake_j.atlas.astype(jnp.float32)).to(torch.bfloat16),
        anchors=_t(bake_j.anchors), T=bake_j.T, extent=bake_j.extent,
        n_channels=bake_j.n_channels, grid_size=bake_j.grid_size,
        bound=bake_j.bound)


def test_plan_and_extended_table_match_jax(trainers):
    tj, tab = trainers["tj"], trainers["tab"]
    occ = np.asarray(tj.state.occ.occ)
    want = jbaked.plan_bake(tj._anchor_table(), occ, 16, 1.0)
    got = tbaked.plan_bake(tab, _t(occ), 16, 1.0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and 0 < want[2] < 16 ** 3
    bake_j = trainers["bake_j"]
    ext = tbaked.extend_anchor_table(tab, _t(bake_j.tile_of_cell),
                                     _t(bake_j.anchors))
    np.testing.assert_array_equal(_np(ext), np.asarray(trainers["ext_j"]))
    assert ext.shape == (16 ** 3, 24)
    # frames of random points through the extended table
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (2000, 3)).astype(np.float32)
    valid = rng.uniform(size=2000) < 0.9
    fj = jbaked.anchor_frames_ext(bake_j, trainers["ext_j"], jnp.asarray(x),
                                  jnp.asarray(valid))
    ft = tbaked.anchor_frames_ext(_port_bake(bake_j), ext, _t(x), _t(valid))
    assert ft.keys() == fj.keys()
    for k in fj:
        np.testing.assert_array_equal(_np(ft[k]), np.asarray(fj[k]),
                                      err_msg=k)
    assert 0 < (_np(ft["tile"]) >= 0).mean() < 1


def test_orthonormal_frame_numpy_and_torch():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    t = rng.normal(size=(300, 3)).astype(np.float32)
    t[:5] = n[:5] * 2.0                         # tangent parallel to normal
    p0 = np.zeros_like(n)
    want = jbaked._orthonormal_frame(p0, n, t)
    got_np = tbaked._orthonormal_frame(p0, n, t)
    got_t = tbaked._orthonormal_frame(_t(p0), _t(n), _t(t))
    for a, b, c in zip(got_np, got_t, want):
        np.testing.assert_array_equal(a, c)
        # t - (t.n) n cancels where the tangent nearly follows the
        # normal: torch's and numpy's norms differ there in the last bits
        _close(b, c, 1e-4)
    t_hat, b_hat = got_np
    nn = n / np.linalg.norm(n, axis=-1, keepdims=True)
    assert np.abs(np.sum(t_hat * nn, -1)).max() < 1e-5
    assert np.abs(np.sum(b_hat * t_hat, -1)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.norm(t_hat, axis=-1), 1.0,
                               atol=1e-5)


def _bf16_ulp(m):
    """One bf16 ulp at magnitude m (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - 7)


def test_bake_atlas_matches_jax(trainers):
    tt, bake_j = trainers["tt"], trainers["bake_j"]
    bake, ext = tt.bake_atlas()
    assert bake.atlas.dtype == torch.bfloat16
    assert (bake.T, bake.n_channels, bake.grid_size) == (
        bake_j.T, bake_j.n_channels, bake_j.grid_size)
    assert bake.extent == pytest.approx(bake_j.extent, rel=1e-7)
    np.testing.assert_array_equal(_np(bake.tile_of_cell),
                                  np.asarray(bake_j.tile_of_cell))
    np.testing.assert_array_equal(_np(bake.anchors),
                                  np.asarray(bake_j.anchors))
    np.testing.assert_array_equal(_np(ext), np.asarray(trainers["ext_j"]))
    a_t = _np(bake.atlas.to(torch.float32))
    a_j = np.asarray(bake_j.atlas.astype(jnp.float32))
    assert a_t.shape == a_j.shape
    mag = np.abs(a_j).max(-1, keepdims=True)
    assert (mag > 0).mean() > 0.99
    off = np.abs(a_t - a_j) > _bf16_ulp(mag)
    assert off.mean() <= 1e-5, off.sum()
    # the padding lanes beyond 4 C stay zero
    assert not a_t[:, 4 * bake.n_channels:].any()
    # the cache: the same atlas until the params or the grid change
    assert tt.bake_atlas()[0] is bake


def test_bake_limits():
    tab = torch.zeros((4, 4, 4, 16))
    with pytest.raises(ValueError, match="no tiles"):
        tbaked.bake_atlas(lambda p: p, tab, torch.zeros(64), 4, 1.0,
                          n_channels=3)
    tab[..., 15] = 1.0
    with pytest.raises(ValueError, match="too large"):
        tbaked.bake_atlas(lambda p: p, tab, torch.ones(64), 4, 1.0,
                          n_channels=3, max_bytes=1e3)
    with pytest.raises(ValueError, match="lanes"):
        tbaked.bake_atlas(lambda p: p, tab, torch.ones(64), 4, 1.0,
                          n_channels=40)


@pytest.mark.parametrize("with_ext", [True, False])
def test_lookup_and_forward_baked_match_jax(trainers, with_ext):
    tj, bake_j = trainers["tj"], trainers["bake_j"]
    rng = np.random.default_rng(2)
    d = rng.normal(size=(3000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * (0.5 + rng.uniform(-0.12, 0.12, (3000, 1)))).astype(np.float32)
    v = rng.normal(size=(3000, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    valid = np.ones(3000, bool)
    bake_t = _port_bake(bake_j)
    if with_ext:
        fj = jbaked.anchor_frames_ext(bake_j, trainers["ext_j"],
                                      jnp.asarray(x), jnp.asarray(valid))
        ft = tbaked.anchor_frames_ext(bake_t, _t(trainers["ext_j"]), _t(x),
                                      _t(valid))
    else:
        fj = jax_frames_from_table(tj._anchor_table(), jnp.asarray(x),
                                   jnp.asarray(valid), 1.0)
        ft = anchor_frames_from_table(trainers["tab"], _t(x), _t(valid), 1.0)
    vals_j, ok_j = jbaked.lookup(bake_j, fj, jnp.asarray(x))
    vals_t, ok_t = tbaked.lookup(bake_t, ft, _t(x))
    np.testing.assert_array_equal(_np(ok_t), np.asarray(ok_j))
    assert np.asarray(ok_j).mean() > 0.5
    scale = float(np.abs(np.asarray(vals_j)).max())
    _close(vals_t, vals_j, 2e-2 * scale)
    pj = tj.state.params
    pt = trainers["tt"].state.params
    rt_j = jmf.FieldRuntime.default()
    s_j, c_j = jcf.forward_baked(pj, bake_j, jnp.asarray(x), jnp.asarray(v),
                                 trainers["cj"], rt_j, fj)
    s_t, c_t = tcf.forward_baked(pt, bake_t, _t(x), _t(v), trainers["ct"],
                                 mesh_field.FieldRuntime.default(), ft)
    s_j = np.asarray(s_j)
    np.testing.assert_array_equal(_np(s_t) > 0, s_j > 0)
    assert (s_j > 0).mean() > 0.2
    _close(s_t, s_j, 1e-2, rtol=1e-2)
    _close(c_t, c_j, 1e-2)
    assert np.asarray(c_j).std() > 1e-2


def test_baked_render_frame_matches_jax(trainers):
    tj, tt = trainers["tj"], trainers["tt"]
    pose = np.asarray(tj.dataset.poses[1])
    want = tj.render_frame(pose, use_ema=False, baked=True)
    got = tt.render_frame(pose, use_ema=False, baked=True)
    assert got["chunks"] >= 2 and 0 < got["live"] < HW * HW
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.05 < live_j.mean() < 0.9 and img_j[live_j].std() > 1e-2
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    # the baked frame differs from the live frame it approximates
    live = _np(tt.render_frame(pose, use_ema=False)["image"])
    assert np.abs(live - img_t).max() > 1e-4


def test_bake_follows_the_params(trainers):
    """A train step updates the params in place: the next baked frame
    bakes anew (and the EMA has a bake of its own)."""
    tt = trainers["tt"]
    saved = tt.state
    try:
        tt.state = tct.init_curved_state(
            tt.generator, trainers["ct"], tt.rcfg, tt.tcfg,
            params=saved.params)
        tt.state.occ = saved.occ
        first, _ = tt.bake_atlas()
        assert tt.bake_atlas()[0] is first
        ema, _ = tt.bake_atlas(use_ema=True)
        assert ema is not first and tt.bake_atlas()[0] is first
        tt.tcfg = dataclasses.replace(tt.tcfg, num_rays=64)
        tt.train(1)
        again, _ = tt.bake_atlas()
        assert again is not first
        assert not torch.equal(again.atlas, first.atlas)
    finally:
        tt.state, tt.tcfg = saved, tct.CurvedTrainConfig()


def test_baked_fallbacks_and_unported(trainers):
    tt = trainers["tt"]
    pose = tt.dataset.poses[2]
    saved_tab = tt._anchor_tab
    tt.anchor_collapse = False
    try:
        # the live field over the uncollapsed table
        live = _np(tt.render_frame(pose, use_ema=False)["image"])
        with pytest.warns(UserWarning, match="falling back"):
            out = tt.render_frame(pose, use_ema=False, baked=True)
        with pytest.raises(ValueError, match="anchor_collapse"):
            tt.bake_atlas()
    finally:
        tt.anchor_collapse = True
        tt._anchor_tab = saved_tab
    np.testing.assert_array_equal(_np(out["image"]), live)
    # deferred shading (ported since item 12) over JAX's atlas, converted
    # (no bake of the port's own here): the per-sample frame's weights,
    # within tests/test_baked.py's mean of its image
    rcfg, saved_bake, st = tt.rcfg, tt._bake, tt.state
    tt._bake = [(st.params, st.step, st.occ, 16,
                 _port_bake(trainers["bake_j"]), _t(trainers["ext_j"]))]
    try:
        per_sample = tt.render_frame(pose, use_ema=False, baked=True)
        tt.rcfg = dataclasses.replace(rcfg, deferred=True)
        deferred = tt.render_frame(pose, use_ema=False, baked=True)
    finally:
        tt.rcfg, tt._bake = rcfg, saved_bake
    assert deferred["live"] == per_sample["live"] > 0
    assert torch.equal(deferred["weights_sum"], per_sample["weights_sum"])
    diff = np.abs(_np(deferred["image"]) - _np(per_sample["image"]))
    assert 0 < diff.mean() < 0.02
    # parity=True ignores baked, as in JAX: the pool frame
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pool = tt.render_frame(pose, use_ema=False, parity=True, baked=True)
    np.testing.assert_array_equal(
        _np(pool["image"]),
        _np(tt.render_frame(pose, use_ema=False, parity=True)["image"]))


def test_deferred_baked_frame_needs_anchor_per_sample(trainers):
    """deferred=True with anchor_per_sample=False on the baked frame (the
    JAX package fails there with a TypeError in its stage 1): a
    ValueError naming both options."""
    tt = trainers["tt"]
    rcfg, saved_bake, st = tt.rcfg, tt._bake, tt.state
    tt._bake = [(st.params, st.step, st.occ, 16,
                 _port_bake(trainers["bake_j"]), _t(trainers["ext_j"]))]
    try:
        tt.rcfg = dataclasses.replace(rcfg, deferred=True,
                                      anchor_per_sample=False)
        with pytest.raises(ValueError,
                           match="deferred=True.*anchor_per_sample"):
            tt.render_frame(tt.dataset.poses[2], use_ema=False, baked=True)
    finally:
        tt.rcfg, tt._bake = rcfg, saved_bake

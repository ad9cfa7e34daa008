"""Relighting in the PyTorch port vs the JAX package: the SG and Envmap
light models inside the curved field (``forward``, ``shade`` and
``color_from_aux`` in every light and visual mode and with the light
rotation, ``shade`` under an imported light).  One training step and a
lockstep run with each are in ``tests/test_torch_relight_train.py``, the
imported environments and their frames in
``tests/test_torch_relight_frames.py``; both use this file's setup.

The configs of ``tests/test_torch_curved_train.py`` (whose helpers this
file uses) with the SG light at 4 lobes and the Envmap light at an 8x8
probe grid; 32x32 training frames, 48x48 rendered frames.  JAX's
projector runs on the port's grid tables (the UV and TBN modes cast
rays through them).

Tolerances, each with its reason:
- field outputs: the field bounds of tests/test_torch_curved_field.py
  (sigma rtol + atol 1e-2, colours and normals 1e-2; masks exact): bf16
  table rows and activations on both sides;
- ``shade`` on the same inputs, learned and imported light: 1e-3 of the
  largest entry (the BRDF MLPs' bf16 operands, and PhySG's amplified
  rounding, tests/test_torch_lights.py; measured 2.5e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curved_train import (
    FIELD, HW, RENDER, TRAIN, _np, _points, _scaled, _t)
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models.lights import sg as jsg
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.utils.transforms import axis_angle_to_matrix as jrot
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.images import write_png
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.utils.transforms import axis_angle_to_matrix

LIGHTS = {"SH": dict(light_model="SH"),
          "SG": dict(light_model="SG", num_lgt_sgs=4),
          "Envmap": dict(light_model="Envmap", env_res=8)}
FRAME_HW = 48
EULER = np.array([0.4, -0.3, 0.2], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (see
    tests/test_torch_training_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_grid(g):
    """The port's GridIndex as the JAX package's."""
    return jspatial.GridIndex(
        cell_items=jnp.asarray(_np(g.cell_items), jnp.int32),
        fallback=jnp.asarray(_np(g.fallback), jnp.int32),
        origin=jnp.asarray(_np(g.origin)),
        cell_size=jnp.asarray(_np(g.cell_size)), res=g.res)


def _configs(light):
    model = dict(hidden_dim=16, geo_feat_dim=7, **LIGHTS[light])
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **model)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **model)
    rj = jr.RenderConfig(**RENDER)
    return (cj, ct, rj, RenderConfig(**dataclasses.asdict(rj)),
            jct.CurvedTrainConfig(**TRAIN), tct.CurvedTrainConfig(**TRAIN))


@pytest.fixture(scope="module")
def setup(request):
    return _make_setup(request.param)


def _make_setup(light):
    """A JAX CurvedTrainer of the light ``light`` (its projector on the
    port's grid tables) after one grid refresh; the port's field state;
    both anchor tables; JAX's params as numpy."""
    cj, ct, rj, rt, tj_cfg, tt_cfg = _configs(light)
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    st = tmf.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                      device="cpu"))
    arrays = JaxMeshProjector(jax_icosphere(2, radius=0.5)).arrays._replace(
        vgrid=_jax_grid(st.projector.vgrid),
        tgrid=_jax_grid(st.projector.tgrid))
    fs = jmf.MeshFieldState(projector=arrays, projector_imported=arrays,
                            imported=jmf.ImportedData.empty())
    tj = jct.CurvedTrainer(ds, fs, cj, rj, tj_cfg, key=jax.random.PRNGKey(0))
    tj.initialize_states(1)
    tab_j = tj._anchor_table()
    return dict(light=light, cj=cj, ct=ct, rj=rj, rt=rt,
                tj_cfg=tj_cfg, tt_cfg=tt_cfg, ds=ds, tj=tj, tab_j=tab_j,
                tab_t=torch.from_numpy(np.array(tab_j)), st=st,
                p=jax.tree.map(np.array, tj.state.params))


def _light_scaled(setup):
    """``_scaled`` params with a light that varies: the SG lobes'
    sharpness spread, the Envmap probe grid x 3."""
    p = _scaled(setup["p"], setup["cj"])
    if setup["light"] == "Envmap":
        p["light"]["env_map"] = p["light"]["env_map"] * 3.0
    return p


def _field_close(got, want):
    s_t, c_t = got
    s_j, c_j = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(_np(s_t) > 0, s_j > 0)
    np.testing.assert_allclose(_np(s_t), s_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(c_t), c_j, rtol=0, atol=1e-2)


@pytest.mark.parametrize("setup", ["SG", "Envmap"], indirect=True)
def test_forward_every_mode_matches_jax(setup):
    cj, ct = setup["cj"], setup["ct"]
    p = _light_scaled(setup)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    x, v, fj, ft = _points(setup, n=1500, seed=3)
    rt_j, rt_t = jmf.FieldRuntime.default(), tmf.FieldRuntime.default()
    fs_j = setup["tj"].field_state
    cases = [dict(visual_mode=m) for m in tcf.VISUAL_MODES]
    cases += [dict(light_visual_mode=m) for m in tcf.LIGHT_VISUAL_MODES]
    cases += [dict(euler_rot=EULER), dict(euler_rot=EULER,
                                          light_visual_mode="Specular")]
    for kw in cases:
        kj = {k: (jrot(jnp.asarray(v_)) if k == "euler_rot" else v_)
              for k, v_ in kw.items()}
        kt = {k: (axis_angle_to_matrix(_t(v_)) if k == "euler_rot" else v_)
              for k, v_ in kw.items()}
        s_j, c_j, _ = jcf.forward(pj, fs_j, jnp.asarray(x), jnp.asarray(v),
                                  cj, rt_j, frames=fj, **kj)
        s_t, c_t, _ = tcf.forward(pt, setup["st"], _t(x), _t(v), ct, rt_t,
                                  frames=ft, **kt)
        try:
            _field_close((s_t, c_t), (s_j, c_j))
        except AssertionError as e:
            raise AssertionError(f"{kw}: {e}") from None
        # the pool path's colour phase, on the sigma phase's aux
        if kw.get("visual_mode") == "Grad":
            continue          # the pool path hands Grad to `forward`
        _, aux_j = jcf.sigma_with_aux(pj, fs_j, jnp.asarray(x),
                                      jnp.asarray(v), cj, rt_j, frames=fj)
        _, aux_t = tcf.sigma_with_aux(pt, setup["st"], _t(x), _t(v), ct,
                                      rt_t, frames=ft)
        cc_j = jcf.color_from_aux(pj, fs_j, jnp.asarray(x), jnp.asarray(v),
                                  aux_j, cj, rt_j, fj, **kj)
        cc_t = tcf.color_from_aux(pt, setup["st"], _t(x), _t(v), aux_t, ct,
                                  rt_t, ft, **kt)
        np.testing.assert_allclose(_np(cc_t), np.asarray(cc_j), rtol=0,
                                   atol=1e-2, err_msg=str(kw))
        assert np.asarray(cc_j).std() > 1e-3, kw
    # the rotation turns the light: the colour moves
    base = tcf.forward(pt, setup["st"], _t(x), _t(v), ct, rt_t, frames=ft)[1]
    rot = tcf.forward(pt, setup["st"], _t(x), _t(v), ct, rt_t, frames=ft,
                      euler_rot=axis_angle_to_matrix(_t(EULER)))[1]
    assert float((base - rot).abs().max()) > 1e-3


def _light_import(setup):
    """An imported light of the model: an SG fit of the sky (JAX's,
    numpy) or an Envmap probe grid."""
    sky = _sky()
    if setup["light"] == "SG":
        return {"lgt_sgs_import": np.asarray(jsg.envmap_to_sg(
            sky, num_sgs=6, iterations=50))}
    return {"env_import": sky[::4, ::8].mean(-1, keepdims=True)}


@pytest.mark.parametrize("setup", ["SG", "Envmap"], indirect=True)
def test_shade_with_imported_light_matches_jax(setup):
    cj, ct = setup["cj"], setup["ct"]
    p = _light_scaled(setup)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    rng = np.random.default_rng(5)
    n = rng.normal(size=(800, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    nc = n + 0.3 * rng.normal(size=n.shape).astype(np.float32)
    nc /= np.linalg.norm(nc, axis=-1, keepdims=True)
    d = rng.normal(size=(800, 3)).astype(np.float32)
    geo = rng.normal(size=(800, 7)).astype(np.float32)
    li = _light_import(setup)
    for imp in (None, li):
        want = jcf.shade(pj, jnp.asarray(geo), jnp.asarray(n),
                         jnp.asarray(d), cj, normal_secondary=jnp.asarray(nc),
                         light_import=None if imp is None else
                         {k: jnp.asarray(v) for k, v in imp.items()})
        got = tcf.shade(pt, _t(geo), _t(n), _t(d), ct,
                        normal_secondary=_t(nc),
                        light_import=None if imp is None else
                        {k: _t(v) for k, v in imp.items()})
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(_np(g), w, rtol=0,
                                       atol=1e-3 * np.abs(w).max())


# ---------------------------------------------------------------------------
# imported environments and frames
# ---------------------------------------------------------------------------

def _sky(H=32, W=64):
    """An analytic sky, f32 [H, W, 3] in [0, 1]: a warm sun over a
    blue-grey dome and a dark ground."""
    th = (np.arange(H) + 0.5) / H * np.pi
    ph = (np.arange(W) + 0.5) / W * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sun = np.exp(-((tt - 0.7) ** 2 + (pp - 2.0) ** 2) * 6.0)
    dome = 0.15 + 0.55 * np.clip(np.cos(tt), 0, 1)
    img = np.stack([dome + sun, dome + 0.8 * sun, 1.2 * dome + 0.4 * sun],
                   -1)
    return np.clip(img, 0, 1).astype(np.float32)


def _sky_png(tmp_path):
    path = str(tmp_path / "sky.png")
    write_png(path, (_sky() * 255).astype(np.uint8))
    return path


def _frame_trainers(setup):
    """A JAX CurvedTrainer on ``setup``'s field state and grid with the
    light-scaled params, and the port's on the same."""
    p = _light_scaled(setup)
    pj = jax.tree.map(jnp.asarray, p)
    ds_j = SyntheticSphereDataset(n_frames=4, H=FRAME_HW, W=FRAME_HW)
    tj = jct.CurvedTrainer(ds_j, setup["tj"].field_state, setup["cj"],
                           setup["rj"], setup["tj_cfg"],
                           key=jax.random.PRNGKey(0))
    tj.state = setup["tj"].state._replace(params=pj, ema_params=pj)
    occ = tj.state.occ
    tt = tct.CurvedTrainer(
        tsyn.SyntheticSphereDataset(n_frames=4, H=FRAME_HW, W=FRAME_HW),
        setup["st"], setup["ct"], setup["rt"], setup["tt_cfg"], device="cpu")
    tt.state.params = params_from_jax(p, device="cpu")
    tt.state.ema_params = tt.state.params
    tt.state.occ = occupancy_from_jax(occ.density, occ.occ, occ.mean_density,
                                      occ.iter_density, device="cpu")
    tt._anchor_tab = (setup["st"].projector, True, setup["tab_t"])
    return tj, tt


def _assert_frames_close(got, want):
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.05 < live_j.mean() < 0.9
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    assert img_j[live_j].std() > 1e-2


def _fit_dirs():
    """The directions JAX's product fit draws (its default key)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4096, 3)))



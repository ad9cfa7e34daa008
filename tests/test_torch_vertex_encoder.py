"""The vertex-feature encoder in the PyTorch port vs the JAX package: the
level schedule, the feature mesh's growth with its feature lift,
``mesh_field.apply`` in every mode, the clustering loss, one training
step's gradients, and a strict refusal to resume a checkpoint saved past
level 0.  The lockstep run across level advances is in
``tests/test_torch_vertex_levels.py``, which uses this file's setup.

Small width: ``make_icosphere(2, 0.5)`` as the template, its feature
mesh subdivided to >= 160 vertices (the template itself, 162), 4
features of 2 frequency bands, the training configs of
``tests/test_torch_curved_train.py``.  The vertex encoder projects each
sample exactly (no anchor frames), so JAX's projectors run on the
port's grid tables (the ray casts walk them).

Tolerances, each with its reason:
- the schedule, the grown mesh (vertices, faces) and the lifted
  features: bit for bit (the same numpy arithmetic);
- ``apply``: masks exact; embeddings 1e-4 of their largest entry (f32
  feature gathers; a frequency band of 2 turns a 1e-7 barycentric
  difference into ~1e-6), coarse normals 1e-5, fine normals 1e-2 (the
  field bounds of tests/test_torch_curved_field.py: the normal net's
  bf16 activations);
- the clustering loss: 1e-6 relative;
- one step: the loss within 1e-4 absolute: the 1e-3 relative of
  tests/test_torch_curved_train.py of a loss of ~0.3, since this
  batch's loss (0.054) nets an MSE of ~0.3 against a cosine term of
  ~-0.25, and JAX's own jitted and eager evaluations of it differ by
  7.3e-5 (the port is 1.2e-4 relative from the eager one, measured);
  each leaf's gradient within 5e-2 of its largest entry (the bounds of
  tests/test_torch_curved_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_curved_train import (RENDER, TRAIN, _data, _flat,
                                     _grad_tree, _np, _rel, _t)
from nerf_texture_tpu.data.rays import get_rays as jax_get_rays
from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry import projector as jproj
from nerf_texture_tpu.geometry import spatial as jspatial
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.models import clustering as jclus
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.geometry import projector as tproj
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.models import clustering as tclus
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=True, encoder_type="vertex", feature_dim=4,
             vertex_multires=2, level_num=3, base_vnum=160,
             target_vnum=2560)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
HW = 32


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


def on_port_grids(jarrays, tarrays):
    """JAX projector arrays with the port projector's grid tables."""
    return jarrays._replace(vgrid=_jax_grid(tarrays.vgrid),
                            tgrid=_jax_grid(tarrays.tgrid))


def _configs(**field):
    f = dict(FIELD, **field)
    vnum0 = tmf.levels_vnum(tmf.MeshFieldConfig(**f))[0]
    fea_t = tmf.make_feature_projector(make_icosphere(2, radius=0.5),
                                       vnum0, device="cpu")
    f["n_feature_vertices"] = int(fea_t.arrays.vertices.shape[0])
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**f), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**f), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    return cj, ct, rj, RenderConfig(**dataclasses.asdict(rj)), fea_t


def make_setup(iters_per_level: int = 0, lr: float = TRAIN["lr"]):
    """A JAX CurvedTrainer with the vertex encoder (its projectors on the
    port's grid tables) after one grid refresh, and the port's field
    state."""
    cj, ct, rj, rt, fea_t = _configs()
    base_t = tproj.MeshProjector(make_icosphere(2, radius=0.5), device="cpu")
    st = tmf.make_state(base_t, fea_projector=fea_t)
    base_j = jproj.MeshProjector(jax_icosphere(2, radius=0.5)).arrays
    fea_j = jmf.make_feature_projector(jax_icosphere(2, radius=0.5),
                                       tmf.levels_vnum(ct.field)[0]).arrays
    base_j = on_port_grids(base_j, st.projector)
    fs = jmf.MeshFieldState(projector=base_j, projector_imported=base_j,
                            imported=jmf.ImportedData.empty(),
                            projector_fea=on_port_grids(fea_j,
                                                        st.projector_fea))
    train = dict(TRAIN, lr=lr, iters_per_level=iters_per_level)
    tj_cfg = jct.CurvedTrainConfig(**train)
    tt_cfg = tct.CurvedTrainConfig(**train)
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    tj = jct.CurvedTrainer(ds, fs, cj, rj, tj_cfg, key=jax.random.PRNGKey(0))
    tj.initialize_states(1)
    return dict(cj=cj, ct=ct, rj=rj, rt=rt, tj_cfg=tj_cfg, tt_cfg=tt_cfg,
                ds=ds, tj=tj, st=st, p=jax.tree.map(np.array,
                                                    tj.state.params))


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def test_levels_and_the_grown_mesh_bit_for_bit():
    for kw in (dict(), dict(level_num=1), dict(level_num=4, base_vnum=4096,
                                               target_vnum=128 ** 2),
               dict(level_num=3, base_vnum=100, target_vnum=1000)):
        f = dict(FIELD, **kw)
        assert tmf.levels_vnum(tmf.MeshFieldConfig(**f)) \
            == jmf.levels_vnum(jmf.MeshFieldConfig(**f))
    _, ct, _, _, fea_t = _configs()
    assert tmf.levels_vnum(ct.field) == (160, 640, 2560)
    fea_j = jmf.make_feature_projector(jax_icosphere(2, radius=0.5), 160)
    np.testing.assert_array_equal(_np(fea_t.arrays.vertices),
                                  np.asarray(fea_j.arrays.vertices))
    rng = np.random.default_rng(0)
    V0 = ct.field.n_feature_vertices
    feats = rng.uniform(-1, 1, (V0, 4)).astype(np.float32)
    ema = rng.uniform(-1, 1, (V0, 4)).astype(np.float32)
    st = tmf.make_state(tproj.MeshProjector(make_icosphere(2, radius=0.5),
                                            device="cpu"),
                        fea_projector=fea_t)
    sj = jmf.make_state(jproj.MeshProjector(jax_icosphere(2, radius=0.5)),
                        fea_projector=fea_j)
    for target in (640, 2560, 3000):
        ft, et, st_new, Vt = tmf.grow_feature_mesh(
            {"features_v": _t(feats)}, {"features_v": _t(ema)}, st,
            ct.field, target)
        fj, ej, sj_new, Vj = jmf.grow_feature_mesh(
            {"features_v": jnp.asarray(feats)},
            {"features_v": jnp.asarray(ema)}, sj, ct.field, target)
        assert Vt == Vj >= target and tuple(ft.shape) == (Vt, 4)
        np.testing.assert_array_equal(_np(ft), np.asarray(fj))
        np.testing.assert_array_equal(_np(et), np.asarray(ej))
        np.testing.assert_array_equal(
            _np(st_new.projector_fea.vertices),
            np.asarray(sj_new.projector_fea.vertices))
        np.testing.assert_array_equal(_np(st_new.projector_fea.faces),
                                      np.asarray(sj_new.projector_fea.faces))
    # the old vertices and their features are a prefix
    np.testing.assert_array_equal(_np(ft[:V0]), feats)
    # a target the mesh already holds keeps it
    same = tmf.grow_feature_mesh({"features_v": _t(feats)},
                                 {"features_v": _t(ema)}, st, ct.field, 100)
    assert same[3] == V0 and torch.equal(same[0], _t(feats))


def _surface_points(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (d * (0.5 + rng.uniform(-0.15, 0.15, (n, 1)))).astype(np.float32)


def _field_close(out_t, out_j, msg=""):
    np.testing.assert_array_equal(_np(out_t.h_mask), np.asarray(out_j.h_mask),
                                  err_msg=msg)
    m = np.asarray(out_j.h_mask)
    assert m.mean() > 0.2, msg
    emb_j = np.asarray(out_j.embed)
    np.testing.assert_allclose(_np(out_t.embed)[m], emb_j[m], rtol=0,
                               atol=1e-4 * np.abs(emb_j[m]).max(),
                               err_msg=msg)
    np.testing.assert_allclose(_np(out_t.normal_coarse)[m],
                               np.asarray(out_j.normal_coarse)[m], rtol=0,
                               atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(_np(out_t.normal_fine)[m],
                               np.asarray(out_j.normal_fine)[m], rtol=0,
                               atol=1e-2, err_msg=msg)


def _imports(setup, rng):
    """The import modes' data, as numpy: a canvas of raw vertex features,
    scattered points and baked vertex features."""
    F, P = 4, setup["ct"].field.normal_cfg.phi_embed_dim
    Hc = 16
    tbn = np.broadcast_to(np.eye(3, dtype=np.float32), (Hc, Hc, 3, 3))
    canvas = dict(features=rng.uniform(-1, 1, (Hc, Hc, F)),
                  sample_tbn=np.eye(3).reshape(1, 9),
                  sample_tbn_ids=np.zeros((Hc, Hc), np.int32),
                  local_tbn=np.ascontiguousarray(tbn),
                  phi_embed=rng.normal(size=(Hc, Hc, P)),
                  bounds=np.array([0.6, 0.6]))
    return canvas, F, P


def test_apply_every_mode_matches_jax(setup):
    ct, cj = setup["ct"], setup["cj"]
    pj = jax.tree.map(jnp.asarray, setup["p"])
    pt = params_from_jax(setup["p"], device="cpu")
    fs_j, st = setup["tj"].field_state, setup["st"]
    x = _surface_points(1500, 1)
    for need in (True, False):
        for grad in (False, True):
            out_j = jmf.apply(pj["field"], fs_j, jnp.asarray(x), cj.field,
                              no_noise=True, need_normals=need,
                              requires_grad_xyz=grad)
            out_t = tmf.apply(pt["field"], st, _t(x), ct.field,
                              no_noise=True, need_normals=need,
                              requires_grad_xyz=grad)
            _field_close(out_t, out_j, f"none need={need} grad={grad}")
    # training features: no noise, no frames
    out_t = tmf.apply(pt["field"], st, _t(x), ct.field, no_noise=False)
    out_j = jmf.apply(pj["field"], fs_j, jnp.asarray(x), cj.field,
                      key=jax.random.PRNGKey(0))
    _field_close(out_t, out_j, "training")
    with pytest.raises(ValueError, match="vertex"):
        tmf.apply(pt["field"], st, _t(x[:4]), ct.field, no_noise=True,
                  frames={"normal": _t(x[:4]), "p0": _t(x[:4]),
                          "tbn": torch.eye(3).expand(4, 3, 3),
                          "hit": torch.ones(4, dtype=torch.bool)})
    rng = np.random.default_rng(2)
    canvas, F, P = _imports(setup, rng)
    # 'field': the flat canvas of raw features, tanh + frequency encoded
    xf = np.concatenate([rng.uniform(-0.7, 0.7, (800, 2)),
                         rng.uniform(-0.15, 0.15, (800, 1))],
                        -1).astype(np.float32)
    imp_t = tmf.import_field_data(**canvas, device="cpu")
    imp_j = jmf.import_field_data(**canvas)
    _field_close(
        tmf.apply(pt["field"], st._replace(imported=imp_t), _t(xf), ct.field,
                  mode="field", no_noise=True),
        jmf.apply(pj["field"], fs_j._replace(imported=imp_j),
                  jnp.asarray(xf), cj.field, mode="field", no_noise=True),
        "field")
    # 'shape': the canvas wrapped onto the template through its UVs
    _field_close(
        tmf.apply(pt["field"], st._replace(imported=imp_t), _t(x), ct.field,
                  mode="shape", no_noise=True),
        jmf.apply(pj["field"], fs_j._replace(imported=imp_j),
                  jnp.asarray(x), cj.field, mode="shape", no_noise=True),
        "shape")
    # 'patch': scattered points with raw features
    pts = _surface_points(400, 3)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    pc_t = tproj.pointcloud_arrays(pts, nrm, device="cpu")
    pc_j = on_port_grids(jproj.pointcloud_arrays(pts, nrm), pc_t)
    ptch = dict(features=rng.uniform(-1, 1, (400, F)),
                local_tbn=np.tile(np.eye(3).reshape(1, 9), (400, 1)),
                phi_embed=rng.normal(size=(400, P)))
    _field_close(
        tmf.apply(pt["field"], st._replace(
            projector_imported=pc_t,
            imported=tmf.import_patch_data(**ptch, device="cpu")), _t(x),
            ct.field, mode="patch", no_noise=True),
        jmf.apply(pj["field"], fs_j._replace(
            projector_imported=pc_j, imported=jmf.import_patch_data(**ptch)),
            jnp.asarray(x), cj.field, mode="patch", no_noise=True),
        "patch")
    # 'unhash': raw features baked at the feature mesh's vertices
    V = ct.field.n_feature_vertices
    bake = dict(features=rng.uniform(-1, 1, (V, F)),
                phi_embed=rng.normal(size=(V, P)))
    _field_close(
        tmf.apply(pt["field"], st._replace(
            projector_imported=st.projector_fea,
            imported=tmf.import_unhash_data(**bake, device="cpu")), _t(x),
            ct.field, mode="unhash", no_noise=True),
        jmf.apply(pj["field"], fs_j._replace(
            projector_imported=fs_j.projector_fea,
            imported=jmf.import_unhash_data(**bake)), jnp.asarray(x),
            cj.field, mode="unhash", no_noise=True),
        "unhash")


def test_clustering_and_kl_match_jax(setup):
    ct, cj = setup["ct"], setup["cj"]
    p = jax.tree.map(np.array, setup["p"])
    p["field"]["clusters"] = np.random.default_rng(4).uniform(
        -1, 1, p["field"]["clusters"].shape).astype(np.float32)
    pj = jax.tree.map(jnp.asarray, p)
    pt = params_from_jax(p, device="cpu")
    want = jmf.clustering_loss(pj["field"], cj.field,
                               key=jax.random.PRNGKey(3))
    assert float(want) > 0
    _rel(tmf.clustering_loss(pt["field"], ct.field, 2), want, 1e-6)
    _rel(tclus.clustering_loss_level(pt["field"]["features_v"],
                                     pt["field"]["clusters"][0]),
         jclus.clustering_loss_level(pj["field"]["features_v"],
                                     pj["field"]["clusters"][0]), 1e-6)
    assert tmf.kl_loss(pt["field"], ct.field) == 0.0 \
        == float(jmf.kl_loss(pj["field"], cj.field))
    _rel(tcf.regular_loss(pt, ct, 0, level=1),
         jcf.regular_loss(pj, cj, 0, key=jax.random.PRNGKey(3)), 1e-6)
    # the init's shapes: U(-1, 1) features, one level of 16 centres
    init = tmf.init(torch.Generator().manual_seed(0), ct.field)
    assert set(init) == set(p["field"])
    assert tuple(init["features_v"].shape) == p["field"]["features_v"].shape
    assert tuple(init["clusters"].shape) == p["field"]["clusters"].shape \
        == (1, 16, 4)
    assert float(init["features_v"].abs().max()) <= 1.0
    with pytest.raises(ValueError, match="n_feature_vertices"):
        tmf.init(torch.Generator(), dataclasses.replace(
            ct.field, n_feature_vertices=0))


def vertex_batch(key, frame, tcfg):
    """The draws JAX's train step takes from ``key``: pixels, march
    jitter, background; the vertex encoder draws no feature noise."""
    k_pix, k_perturb, k_bg, _, k_reg = jax.random.split(key, 5)
    n = tcfg.num_rays
    inds, _ = jax_sample(k_pix, HW, HW, n)
    return tct.CurvedBatch(
        frame=torch.tensor(int(frame)), inds=_t(inds).to(torch.int64),
        u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        bg=_t(jax.random.uniform(k_bg, (n, 3))), noise=None,
        level=int(jax.random.randint(k_reg, (), 0, 3)))


def _jax_loss(params, jstate, tj, frame, key, cj, rj, tcfg):
    """The loss of JAX's ``_curved_train_step_body`` without anchor
    frames, rebuilt from its pieces (the same keys)."""
    k_pix, k_perturb, k_bg, k_noise, k_reg = jax.random.split(key, 5)
    inds, _ = jax_sample(k_pix, HW, HW, tcfg.num_rays)
    pixels = tj.images[frame].reshape(HW * HW, -1)[inds].astype(
        jnp.float32) / 255.0
    bg = jax.random.uniform(k_bg, (tcfg.num_rays, 3))
    gt = pixels[:, :3] * pixels[:, 3:] + bg * (1 - pixels[:, 3:])
    rays = jax_get_rays(tj.poses[frame], tj.intrinsics, HW, HW, inds)

    def field(x, d):
        return jcf.forward(params, tj.field_state, x, d, cj, tj.runtime,
                           key=k_noise, training=True)

    out = jr.render_rays(field, jstate.occ.occ, rays["rays_o"],
                         rays["rays_d"], rj, max_samples=rj.max_samples_train,
                         key=k_perturb, perturb=True, bg_color=bg)
    loss = jnp.mean(jnp.mean((out["image"] - gt) ** 2, axis=-1))
    n_est, n_grad = out["normal"], jax.lax.stop_gradient(out["normal_grad"])
    finite = (jnp.all(jnp.isfinite(n_grad), axis=-1)
              & (jnp.sum(n_grad * n_grad, -1) > 1e-8))
    n_est_n = n_est * jax.lax.rsqrt(jnp.sum(n_est * n_est, -1,
                                            keepdims=True) + 1e-10)
    n_grad_n = n_grad * jax.lax.rsqrt(jnp.sum(n_grad * n_grad, -1,
                                              keepdims=True) + 1e-10)
    err = -jnp.minimum(jnp.sum(n_grad_n * n_est_n, -1),
                       tcfg.normal_cosine_threshold)
    loss = loss + jnp.sum(jnp.where(finite, err, 0.0)) \
        / jnp.maximum(jnp.sum(finite), 1)
    return loss + jcf.regular_loss(params, cj, jstate.step, key=k_reg)


def port_state(setup, jstate):
    """The port's state holding a JAX state's params, EMA and grid."""
    from nerf_texture_tpu_torch.convert import occupancy_from_jax

    st = tct.init_curved_state(
        torch.Generator(), setup["ct"], setup["rt"], setup["tt_cfg"],
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               device="cpu"))
    st.ema_params = params_from_jax(jax.tree.map(np.asarray,
                                                 jstate.ema_params),
                                    device="cpu")
    o = jstate.occ
    st.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                o.iter_density, device="cpu")
    return st


def step_kw(setup, ccfg=None):
    return dict(ccfg=ccfg or setup["ct"], rcfg=setup["rt"],
                tcfg=setup["tt_cfg"], H=HW, W=HW,
                rt=tmf.FieldRuntime.default(), anchor_tab=None)


def test_one_train_step_matches_jax(setup):
    tj, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    jstate = tj.state
    key, frame = jax.random.PRNGKey(21), 1
    lj, g_j = jax.jit(jax.value_and_grad(lambda p, st, k: _jax_loss(
        p, st, tj, frame, k, cj, rj, tcfg)))(jstate.params, jstate, key)
    pstate = port_state(setup, jstate)
    poses, images, intr = _data(setup)
    batch = vertex_batch(key, frame, tcfg)
    lt, out = tct.curved_train_loss(pstate.params, pstate.occ, batch,
                                    setup["st"], poses, images, intr,
                                    **step_kw(setup))
    assert {"normal", "normal_grad"} <= set(out)
    lt.backward(inputs=tct.param_leaves(pstate.params))
    assert abs(float(lt) - float(lj)) <= 1e-4, (float(lt), float(lj))
    got = _flat(_grad_tree(pstate.params))
    want = _flat(jax.tree.map(np.asarray, g_j))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=5e-2 * float(np.abs(w).max()),
                                   err_msg=str(path))
    assert float(np.abs(want[("field", "features_v")]).max()) > 0
    # the batch draws no feature noise for the vertex encoder
    g = torch.Generator().manual_seed(0)
    b = tct.sample_curved_batch(g, num_frames=4, H=HW, W=HW,
                                tcfg=setup["tt_cfg"], rcfg=setup["rt"],
                                fcfg=setup["ct"].field, level=0)
    assert b.noise is None


def test_resume_past_level_zero_is_refused(setup, tmp_path):
    """A checkpoint saved after a level advance holds the grown features:
    a strict restore into a trainer at level 0 fails in both packages
    (there is no resume across levels)."""
    ct, rt = setup["ct"], setup["rt"]
    tcfg = dataclasses.replace(setup["tt_cfg"], iters_per_level=2)
    tt = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=4, H=HW,
                                                       W=HW),
                           setup["st"], ct, rt, tcfg, device="cpu", seed=1)
    tt.train(3)          # the loop advances to level 1 before step 2
    assert tt.fea_level == 1 and tt.ccfg.field.n_feature_vertices == 642
    assert tt.state.params["field"]["features_v"].shape[0] == 642
    path = str(tmp_path / "port")
    tt.save_checkpoint(path)
    fresh = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=4, H=HW,
                                                          W=HW),
                              setup["st"], ct, rt, tcfg, device="cpu",
                              seed=1)
    with pytest.raises(ValueError, match="features_v"):
        fresh.load_checkpoint(path)
    # the same trainer reloads its own checkpoint
    tt.load_checkpoint(path)
    tj = setup["tj"]
    tj_cfg = dataclasses.replace(setup["tj_cfg"], iters_per_level=2)
    tj2 = jct.CurvedTrainer(setup["ds"], tj.field_state, setup["cj"],
                            setup["rj"], tj_cfg, key=jax.random.PRNGKey(1))
    assert tj2.update_field_level(1)
    jpath = str(tmp_path / "jax")
    tj2.save_checkpoint(jpath)
    tj3 = jct.CurvedTrainer(setup["ds"], tj.field_state, setup["cj"],
                            setup["rj"], tj_cfg, key=jax.random.PRNGKey(1))
    with pytest.raises(Exception):
        tj3.load_checkpoint(jpath)

"""The flat texture pipeline of the PyTorch port vs the JAX package:
patch export (``save_field`` -> ``sample_patches``), quilting, the import
of the quilted texture (``load_field``, mode 'field') and of one patch
(``load_patch``, mode 'patch'), and their frames; the host mirrors
(quilting, seams, surface sampling, mesh files) and ``grid_sample_2d``.

Small width: the configs of ``tests/test_field_io.py`` (3 levels x 2
channels, grid 16, ``make_icosphere(2, 0.5)``), 8x8 patches, a 32x32
canvas, 32x32 frames; converted, seeded JAX params (the encoder's mean
lanes x 1e4, the phi grid x 1e3, so the features vary), not training.

Tolerances, each with its reason:
- the host mirrors (quilting, seams, surface sampling, PCA, mesh files):
  bit for bit -- the same numpy statements on the same input;
- ``grid_sample_2d``: 1e-6 (the same f32 formula);
- ``sample_patches``: the same centres, normals and sample frames bit
  for bit (host numpy), the same kept patches; hits within 1e-5 and
  local TBNs exactly but at face ties (the ray cast's bounds,
  tests/test_torch_projection.py); features and phi embeddings within
  1e-4 of their largest entry (f32 tables read at surface points that
  agree within 1e-5; the scaled phi grid has slopes of ~10 a unit;
  measured 3.9e-5);
- the grid refresh of each import mode with JAX's jitter: masks exact,
  densities within 1e-5 (relative) for >= 99% of cells;
- frames of the imported texture and patch on JAX's grid: the frame
  bounds of test_torch_curved_render.py, PSNR >= 45 dB, max abs error
  <= 5e-2, live pixels differing <= 0.5%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_draws import curved_grid_noise
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry import mesh as jmesh
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.synthesis import patches as jpatches
from nerf_texture_tpu.synthesis import quilting as jquilt
from nerf_texture_tpu.synthesis import seams as jseams
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.train import field_io as jio
from nerf_texture_tpu.utils.grid_sample import grid_sample_2d as jax_gs
from nerf_texture_tpu_torch.convert import occupancy_from_jax, params_from_jax
from nerf_texture_tpu_torch.data import synthetic as tsyn
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.geometry import mesh as tmesh
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.synthesis import patches as tpatches
from nerf_texture_tpu_torch.synthesis import quilting as tquilt
from nerf_texture_tpu_torch.synthesis import seams as tseams
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.train import field_io as tio
from nerf_texture_tpu_torch.utils.grid_sample import grid_sample_2d

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
SCFG = dict(patch_size=8, max_patch_num=6, center_batch=3, pattern_rate=1 / 4)
HW = 32
# straight down onto the z = 0 canvas, and an oblique view of it
POSES = [orbit_pose(np.pi / 2, 0.0, 2.0), orbit_pose(np.pi / 2 - 0.5, 0.4,
                                                     2.0)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The ray cast and the kNN run many small tensor ops: beside
    pytest-xdist's other workers, a full intra-op thread pool makes each
    of them wait on the busy cores (this file took ~10x its time alone
    in a 6-worker run).  Two threads a worker for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# host mirrors and grid_sample_2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_2d_matches(mode):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(13, 17, 5)).astype(np.float32)
    xy = rng.uniform(-1.2, 1.2, (2000, 2)).astype(np.float32)
    xy[:4] = [[-1, -1], [1, 1], [0, 0], [1, -1]]        # corners, centre
    got = _np(grid_sample_2d(_t(img), _t(xy), mode=mode))
    want = np.asarray(jax_gs(jnp.asarray(img), jnp.asarray(xy), mode=mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == 0).all(-1).mean() > 0.1          # zero padding outside
    got = _np(grid_sample_2d(_t(img), _t(xy), mode=mode,
                             padding_zero=False))
    want = np.asarray(jax_gs(jnp.asarray(img), jnp.asarray(xy), mode=mode,
                             padding_zero=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _patches(seed, n=12, texel=16, dim=7):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, texel, texel, dim))
    smooth = np.cumsum(np.cumsum(base, 1), 2) / texel
    stbn = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                     for _ in range(n)]).reshape(n, 9)
    return smooth, stbn, rng.normal(size=(n, 3))


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(mode="blend", seed=3),
    dict(mirror_hor=True, mirror_vert=True, strict_match=False),
    dict(coarse_kdtree=False, close_threshold=0.0, output_size=(40, 40)),
])
def test_quilting_matches_bit_for_bit(cfg):
    patches, stbn, picked = _patches(1)
    outs = []
    for mod in (tquilt, jquilt):
        qc = mod.QuiltingConfig(**dict(dict(output_size=(48, 48), seed=1),
                                       **cfg))
        syn = mod.QuiltingSynthesizer(patches, qc, match_dim=4,
                                      sample_tbn=stbn,
                                      picked_vertices=picked,
                                      patch_length=0.3)
        canvas, cid = syn.synthesize()
        outs.append((canvas, cid, syn.export(grid_gap=0.01,
                                             phi_embed_dim=2)))
    (c_t, i_t, e_t), (c_j, i_j, e_j) = outs
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(i_t, i_j)
    assert e_t.keys() == e_j.keys()
    for k in e_t:
        if e_t[k] is None:
            assert e_j[k] is None
        else:
            np.testing.assert_array_equal(e_t[k], e_j[k], err_msg=k)
    assert len(np.unique(i_t)) > 2                   # several patches placed


def test_seams_and_block_reduce_match():
    rng = np.random.default_rng(2)
    b1, b2 = rng.normal(size=(2, 20, 9, 5))
    for a, b in zip(tquilt.min_error_boundary_cut(b1, b2, 3),
                    jquilt.min_error_boundary_cut(b1, b2, 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tseams.floyd_cut(b1, b2, 3), jseams.floyd_cut(b1, b2, 3)):
        np.testing.assert_array_equal(a, b)
    x = rng.normal(size=(2, 9, 10, 3))
    np.testing.assert_array_equal(tquilt.block_reduce_mean(x, (1, 2, 3, 1)),
                                  jquilt.block_reduce_mean(x, (1, 2, 3, 1)))


def test_surface_sampling_matches_bit_for_bit():
    mt, mj = tmesh.make_icosphere(2, 0.5), jmesh.make_icosphere(2, 0.5)
    for subset in (None, np.arange(40, 90)):
        np.testing.assert_array_equal(
            tpatches.poisson_disk_sample(mt, 30, 4, face_subset=subset),
            jpatches.poisson_disk_sample(mj, 30, 4, face_subset=subset))
    np.testing.assert_array_equal(
        tpatches.sample_surface(mt, 50, np.random.default_rng(1)),
        jpatches.sample_surface(mj, 50, np.random.default_rng(1)))
    np.testing.assert_array_equal(tpatches.pca_first_component(mt.vertices),
                                  jpatches.pca_first_component(mj.vertices))
    assert [f.name for f in dataclasses.fields(tpatches.PatchSampleConfig)] \
        == [f.name for f in dataclasses.fields(jpatches.PatchSampleConfig)]
    assert dataclasses.asdict(tpatches.PatchSampleConfig()) == \
        dataclasses.asdict(jpatches.PatchSampleConfig())
    assert dataclasses.asdict(tquilt.QuiltingConfig()) == \
        dataclasses.asdict(jquilt.QuiltingConfig())


def test_mesh_primitives_and_files_match(tmp_path):
    for make in (lambda m: m.make_box((0.3, 0.4, 0.5)),
                 lambda m: m.make_plane(5, 0.7),
                 lambda m: m.make_icosphere(1, 0.5)):
        mt, mj = make(tmesh), make(jmesh)
        np.testing.assert_array_equal(mt.vertices, mj.vertices)
        np.testing.assert_array_equal(mt.faces, mj.faces)
        assert (mt.uvs is None) == (mj.uvs is None)
        for a, b in zip(mt.aabb, mj.aabb):
            np.testing.assert_array_equal(a, b)
        c = mt.copy()
        assert c.vertices is not mt.vertices
        np.testing.assert_array_equal(c.vertices, mt.vertices)
        pt, pj = tmp_path / "t.obj", tmp_path / "j.obj"
        tmesh.save_obj(str(pt), mt)
        jmesh.save_obj(str(pj), mj)
        assert pt.read_bytes() == pj.read_bytes()
        lt, lj = tmesh.load_obj(str(pj)), jmesh.load_obj(str(pt))
        np.testing.assert_array_equal(lt.vertices, lj.vertices)
        np.testing.assert_array_equal(lt.faces, lj.faces)
        if lj.uvs is not None:
            np.testing.assert_array_equal(lt.uvs, lj.uvs)
    # a quad face splits into a fan of two triangles
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                    "vt 1 1\nvt 0 1\nf 1/1 2/2 3/3 4/4\n")
    lt, lj = tmesh.load_obj(str(quad)), jmesh.load_obj(str(quad))
    np.testing.assert_array_equal(lt.faces, lj.faces)
    np.testing.assert_array_equal(lt.uvs, lj.uvs)
    rng = np.random.default_rng(3)
    pts, cols = rng.normal(size=(20, 3)), rng.integers(0, 255, (20, 3))
    for colors in (None, cols):
        tmesh.save_ply_points(str(tmp_path / "t.ply"), pts, colors)
        jmesh.save_ply_points(str(tmp_path / "j.ply"), pts, colors)
        assert (tmp_path / "t.ply").read_bytes() == \
            (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(
        tmesh.load_ply_points(str(tmp_path / "j.ply")),
        jmesh.load_ply_points(str(tmp_path / "t.ply")))


# ---------------------------------------------------------------------------
# the pipeline on a seeded field
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """JAX and port CurvedTrainers on the same seeded params and grid, and
    the JAX package's field npz and quilted texture npz."""
    d = tmp_path_factory.mktemp("texture")
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    rj = jr.RenderConfig(**RENDER)
    rt = RenderConfig(**dataclasses.asdict(rj))
    ds = SyntheticSphereDataset(n_frames=2, H=HW, W=HW)
    mesh_j = jmesh.make_icosphere(2, radius=0.5)
    tj = jct.CurvedTrainer(ds, jmf.make_state(JaxMeshProjector(mesh_j)), cj,
                           rj, jct.CurvedTrainConfig(),
                           key=jax.random.PRNGKey(0))
    p = jax.tree.map(np.array, tj.state.params)
    rw = cj.field.feature_spec.row_width
    p["field"]["encoder"][:, :rw] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    pj = jax.tree.map(jnp.asarray, p)
    tj.state = tj.state._replace(params=pj, ema_params=pj)
    tj.initialize_states(1)
    mesh_t = tmesh.make_icosphere(2, radius=0.5)
    tt = tct.CurvedTrainer(tsyn.SyntheticSphereDataset(n_frames=2, H=HW,
                                                       W=HW),
                           tmf.make_state(MeshProjector(mesh_t,
                                                        device="cpu")),
                           ct, rt, tct.CurvedTrainConfig(), device="cpu")
    tt.state.params = params_from_jax(p, device="cpu")
    tt.state.ema_params = tt.state.params
    field_j = str(d / "field_jax.npz")
    jio.save_field(tj, field_j, mesh=mesh_j,
                   scfg=jpatches.PatchSampleConfig(**SCFG))
    tex_j = str(d / "texture_jax.npz")
    _quilt(jquilt, field_j, tex_j)
    return dict(cj=cj, ct=ct, rj=rj, rt=rt, tj=tj, tt=tt, mesh_t=mesh_t,
                mesh_j=mesh_j, field_j=field_j, tex_j=tex_j, dir=d,
                occ0=tj.state.occ)


def _quilt(mod, field_path, tex_path):
    """test_field_io.py's quilting of a field npz into a texture npz."""
    data = np.load(field_path, allow_pickle=True)
    patches = np.concatenate(
        [data["patches"], data["patch_phi_embed"],
         data["patch_local_tbn"].reshape(*data["patch_local_tbn"].shape[:3],
                                         9)], -1)
    syn = mod.QuiltingSynthesizer(
        patches, mod.QuiltingConfig(output_size=(32, 32), seed=0),
        match_dim=data["patches"].shape[-1],
        sample_tbn=data["patch_sample_tbn"],
        picked_vertices=data["picked_vertices"],
        patch_length=float(data["grid_gap"]) * 8)
    syn.synthesize()
    tex = syn.export(grid_gap=float(data["grid_gap"]),
                     phi_embed_dim=data["patch_phi_embed"].shape[-1])
    np.savez(tex_path, **{k: v for k, v in tex.items() if v is not None})


def test_sample_patches_matches(pipeline):
    s = pipeline
    stats = {}
    path = str(s["dir"] / "field_port.npz")
    out_t = tio.save_field(s["tt"], path, mesh=s["mesh_t"],
                           scfg=tpatches.PatchSampleConfig(**SCFG),
                           stats=stats)
    want = dict(np.load(s["field_j"], allow_pickle=True))
    got = dict(np.load(path, allow_pickle=True))
    assert got.keys() == want.keys()
    n = len(want["patches"])
    assert n == SCFG["max_patch_num"] and len(got["patches"]) == n
    assert stats["candidates"] >= n
    assert 0 < stats["rays"] <= stats["candidates"] * SCFG["patch_size"] ** 2
    for k in ("picked_vertices", "patch_norms", "patch_sample_tbn",
              "grid_gap", "mesh_vertices", "mesh_faces"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("patches", "patch_phi_embed"):
        scale = float(np.abs(want[k]).max())
        assert scale > 0
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * scale, err_msg=k)
    np.testing.assert_allclose(got["patch_coors"], want["patch_coors"],
                               rtol=0, atol=1e-5)
    same = np.all(got["patch_local_tbn"] == want["patch_local_tbn"], -1)
    assert same.mean() >= 0.99
    assert out_t["patches"].dtype == want["patches"].dtype


def _grid_noise(key, n, rj):
    """The jitter of JAX's sparse refresh from ``key``: one chunk of
    65,536 cells (the import modes' chunk)."""
    return curved_grid_noise(key, n, rj.grid_size, chunk=65536)


def _jax_load_patch(tj, path, patch_id, n_refresh):
    """``jio.load_patch`` with ``n_refresh`` grid refreshes in place of
    its 50: the JAX package refreshes the patch mode in padded chunks of
    65,536 cells through the kNN projection, ~2 s each on the CPU."""
    data = np.load(path, allow_pickle=True)
    pid = patch_id % data["patches"].shape[0]
    coors = data["patch_coors"][pid].reshape(-1, 3)
    imported = jmf.import_patch_data(
        features=data["patches"][pid].reshape(-1, data["patches"].shape[-1]),
        local_tbn=data["patch_local_tbn"][pid].reshape(-1, 9),
        phi_embed=data["patch_phi_embed"][pid].reshape(
            -1, data["patch_phi_embed"].shape[-1]))
    pc = jio.pointcloud_arrays(coors, np.tile(data["patch_norms"][pid][None],
                                              (len(coors), 1)))
    tj.field_state = tj.field_state._replace(imported=imported,
                                             projector_imported=pc)
    tj.mode = "patch"
    tj.initialize_states(n_refresh)


def _import(s, mode):
    """Both trainers in import mode ``mode`` from the JAX package's files
    (each refreshed its own way), then the port on JAX's grid."""
    tj, tt = s["tj"], s["tt"]
    o = s["occ0"]
    tj.state = tj.state._replace(occ=o)
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    if mode == "field":
        jio.load_field(tj, s["tex_j"])
        tio.load_field(tt, s["tex_j"])
    else:
        _jax_load_patch(tj, s["field_j"], 1, 1)
        tio.load_patch(tt, s["field_j"], patch_id=1)
    assert tj.mode == tt.mode == mode
    o = tj.state.occ
    own = tt.state.occ
    tt.state.occ = occupancy_from_jax(o.density, o.occ, o.mean_density,
                                      o.iter_density, device="cpu")
    return own


def _assert_frames_close(got, want):
    img_t, img_j = _np(got["image"]), np.asarray(want["image"])
    live_t = _np(got["weights_sum"]) > 0
    live_j = np.asarray(want["weights_sum"]) > 0
    assert 0.02 < live_j.mean() < 0.95, live_j.mean()
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(img_t - img_j)
    assert err.max() <= 5e-2, err.max()
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
    assert img_j[live_j].std() > 1e-3


@pytest.mark.parametrize("mode", ["field", "patch"])
def test_imported_frames_match(pipeline, mode):
    s = pipeline
    tj, tt = s["tj"], s["tt"]
    own = _import(s, mode)
    # the port's own 50 refreshes occupy the imported surface as JAX's do
    # (the JAX patch import above refreshed once)
    assert int(own.iter_density) == 51
    near = tj._get_near_cells()
    occ_t, occ_j = _np(own.occ), np.asarray(tj.state.occ.occ)
    assert occ_j[near].sum() > 0
    if mode == "field":
        assert int(tj.state.occ.iter_density) == 51
        assert (occ_t == occ_j).mean() >= 0.99
    else:
        assert (occ_t[near] == occ_j[near]).mean() >= 0.95
    for pose in POSES:
        _assert_frames_close(tt.render_frame(pose, use_ema=False),
                             tj.render_frame(pose, use_ema=False))
    # the default RenderConfig's two-round proxy renders the import too
    rj, rt = tj.rcfg, tt.rcfg
    try:
        tj.rcfg = dataclasses.replace(rj, proxy_samples=32)
        tt.rcfg = dataclasses.replace(rt, proxy_samples=32)
        _assert_frames_close(tt.render_frame(POSES[1], use_ema=False),
                             tj.render_frame(POSES[1], use_ema=False))
    finally:
        tj.rcfg, tt.rcfg = rj, rt


@pytest.mark.parametrize("mode", ["field", "patch"])
def test_import_refresh_matches_jax_with_its_jitter(pipeline, mode):
    s = pipeline
    tj, tt, cj, ct, rj, rt = (s[k] for k in ("tj", "tt", "cj", "ct", "rj",
                                             "rt"))
    _import(s, mode)
    near = tj._get_near_cells()
    np.testing.assert_array_equal(_np(tt._get_near_cells()), near)
    assert len(near) < 65536
    key = jax.random.PRNGKey(5)
    st_j = jct.curved_grid_step(
        tj.state._replace(occ=jocc.create(rj.grid_size, 1)), tj.field_state,
        key, ccfg=cj, rcfg=rj, mode=mode, near_cells=near, rt=tj.runtime)
    st_t = dataclasses.replace(
        tt.state, occ=tct.occ_mod.create(rt.grid_size, 1, device="cpu"),
        params=tct.curved_infer_params(tt.state.params, ct))
    st_t = tct.curved_grid_step(
        st_t, tt.field_state, [torch.from_numpy(_grid_noise(key, len(near),
                                                            rj))],
        ccfg=ct, rcfg=rt, mode=mode, near_cells=near, rt=tt.runtime)
    np.testing.assert_array_equal(_np(st_t.occ.occ), np.asarray(st_j.occ.occ))
    assert 0 < _np(st_t.occ.occ).sum()
    d_t, d_j = _np(st_t.occ.density), np.asarray(st_j.occ.density)
    close = np.abs(d_t - d_j) <= 1e-5 * np.maximum(np.abs(d_j), 1.0)
    assert close.mean() >= 0.99


def test_npz_round_trip_between_packages(pipeline):
    """A field npz and a texture npz written by the port load in the JAX
    package, and the JAX package's in the port (the frames above)."""
    s = pipeline
    tj, tt = s["tj"], s["tt"]
    field_t = str(s["dir"] / "field_rt.npz")
    tio.save_field(tt, field_t, mesh=s["mesh_t"],
                   scfg=tpatches.PatchSampleConfig(**SCFG))
    tex_t = str(s["dir"] / "texture_rt.npz")
    _quilt(tquilt, field_t, tex_t)
    for mine, theirs in ((field_t, s["field_j"]), (tex_t, s["tex_j"])):
        a, b = np.load(mine, allow_pickle=True), np.load(theirs,
                                                         allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    tj.state = tj.state._replace(occ=s["occ0"])
    jio.load_field(tj, tex_t)
    assert np.isfinite(np.asarray(tj.render_frame(
        POSES[0], use_ema=False)["image"])).all()
    _jax_load_patch(tj, field_t, 0, 1)
    assert tj.mode == "patch"


def test_import_constructors_match():
    rng = np.random.default_rng(6)
    H, W = 6, 5
    args = dict(features=rng.normal(size=(H, W, 4)),
                sample_tbn=np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                                     for _ in range(3)]).reshape(3, 9),
                sample_tbn_ids=rng.integers(0, 3, (H, W)),
                local_tbn=rng.normal(size=(H, W, 3, 3)),
                phi_embed=rng.normal(size=(H, W, 2)), bounds=[0.4, 0.3])
    a = tmf.import_field_data(**args, device="cpu")
    b = jmf.import_field_data(**args)
    for k in a._fields:
        np.testing.assert_array_equal(_np(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    pa = dict(features=rng.normal(size=(30, 4)),
              local_tbn=rng.normal(size=(30, 9)),
              phi_embed=rng.normal(size=(30, 2)))
    for a, b in ((tmf.import_patch_data(**pa, device="cpu"),
                  jmf.import_patch_data(**pa)),
                 (tmf.import_unhash_data(pa["features"], device="cpu"),
                  jmf.import_unhash_data(pa["features"]))):
        for k in a._fields:
            np.testing.assert_array_equal(_np(getattr(a, k)),
                                          np.asarray(getattr(b, k)),
                                          err_msg=k)


def test_unported_imports_raise(pipeline):
    """Training in an import mode stays unported (item 11.2); the imports
    onto another mesh and the exports run (tests/test_torch_shape_import.py,
    tests/test_torch_surfaces.py)."""
    tt = pipeline["tt"]
    mode = tt.mode
    for m in ("field", "patch", "shape", "unhash"):
        tt.mode = m
        try:
            with pytest.raises(NotImplementedError, match="item 11.2"):
                tt.train(1)
        finally:
            tt.mode = mode

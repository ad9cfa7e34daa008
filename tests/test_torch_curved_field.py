"""The curved model's field modules in the PyTorch port vs the JAX
package: the frequency encoding, the dual hash-grid encode, the normal
net, the SH light, mesh_field.apply through anchor frames (without and
with JAX's noise draw), and curved_field's forward (with the SH light
and with the colour MLP), sigma_with_aux and color_from_aux.  Params are the JAX init's, converted, with the encoder
mean lanes x 1e4 and the phi grid x 1e3 so that the features matter;
the anchor frames are read from JAX's anchor table, converted.

Tolerances, each with its reason:
- freq_encode: 1e-6 (sin / cos of the same f32 products);
- the dual encode on an f32 table: 1e-6 (27-term sum order); through
  bf16 rows (``amp``): 1e-3, the existing bf16-table tolerance (a
  lattice weight can round to the neighbouring bf16 value);
- normal_net.apply with the same inputs: 1e-5 (f32 Lipschitz MLPs and
  trig);
- sh.apply, mesh_field.apply, curved_field.forward, sigma_with_aux and
  color_from_aux: PR 1's NGP field tolerances -- sigma rtol + atol
  1e-2, colours and normals 1e-2, features 2e-2 -- as both sides round
  the table products and MLP activations to bf16 and a last-bit
  difference can round to the neighbouring bf16 value; masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.geometry.projector import (
    anchor_frames_from_table as jax_frames_from_table)
from nerf_texture_tpu.geometry.projector import (
    build_anchor_table as jax_build_anchor_table)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models import normal_net as jnn
from nerf_texture_tpu.models.lights import sh as jsh
from nerf_texture_tpu.ops import encoding as jenc
from nerf_texture_tpu.ops import hashgrid_packed as jhp
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import (
    MeshProjector, anchor_frames_from_table)
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.models import normal_net as tnn
from nerf_texture_tpu_torch.models.lights import sh as tsh
from nerf_texture_tpu_torch.ops import encoding as tenc
from nerf_texture_tpu_torch.ops import hashgrid_packed as thp
from nerf_texture_tpu_torch.train.curved_trainer import curved_infer_params

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
GRID = 16
N = 3000


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    """Configs, params (JAX tree and converted), points near the shell,
    their anchor frames in both packages, view directions, field state."""
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    p = jax.tree.map(np.array, jcf.init(jax.random.PRNGKey(1), cj))
    rw = cj.field.feature_spec.row_width
    p["field"]["encoder"][:, :rw] *= 1e4
    p["field"]["normal"]["phi_grid"] *= 1e3
    pj = jax.tree.map(jnp.asarray, p)
    pt = params_from_jax(p, device="cpu")
    mp_j = JaxMeshProjector(jax_icosphere(2, radius=0.5))
    mp_t = MeshProjector(make_icosphere(2, radius=0.5), device="cpu")
    tab = jax_build_anchor_table(mp_j.arrays, GRID, 1.0, k=8,
                                 max_dist=4 * 0.12 + 4.0 / GRID)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * (0.5 + rng.uniform(-0.15, 0.15, (N, 1)))).astype(np.float32)
    valid = rng.uniform(size=N) < 0.95
    fj = jax_frames_from_table(tab, jnp.asarray(x), jnp.asarray(valid), 1.0)
    ft = anchor_frames_from_table(_t(tab), _t(x), _t(valid), 1.0)
    v = rng.normal(size=(N, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    return dict(cj=cj, ct=ct, pj=pj, pt=pt, x=x, v=v, fj=fj, ft=ft,
                sj=jmf.make_state(mp_j), st=tmf.make_state(mp_t))


def test_freq_encode_matches():
    x = np.random.default_rng(1).uniform(-0.2, 0.2, (500, 1)).astype(
        np.float32)
    for n in (1, 4, 12):
        _close(tenc.freq_encode(_t(x), n), jenc.freq_encode(jnp.asarray(x),
                                                            n), 1e-6)
        assert tenc.freq_encode_dim(1, n) == jenc.freq_encode_dim(1, n)
    _close(tenc.freq_encode(_t(x), 5, log_sampling=False),
           jenc.freq_encode(jnp.asarray(x), 5, log_sampling=False), 1e-5)


def test_init_trees_match_jax(setup):
    """Seeded port params have the JAX tree: keys, list lengths, shapes
    and dtypes (so a converted JAX state drops in one to one)."""
    got = tcf.init(torch.Generator().manual_seed(0), setup["ct"])
    want = setup["pj"]

    def walk(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], path + (k,))
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                walk(u, v, path + (i,))
        else:
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path

    walk(got, want, ())
    enc = got["field"]["encoder"]
    rw = setup["ct"].field.feature_spec.row_width
    assert float(enc[:, :rw].abs().max()) <= 1e-4
    np.testing.assert_allclose(_np(enc[:, rw:]).mean(), -8.0, atol=1e-5)


@pytest.mark.parametrize("amp", [False, True])
def test_dual_encode_matches(setup, amp):
    spec = setup["cj"].field.feature_spec
    tspec = setup["ct"].field.feature_spec
    assert spec.dual_storage_width == tspec.dual_storage_width
    x = setup["x"]
    table = setup["pj"]["field"]["encoder"]
    a_j, b_j = jhp.packed_encode_bound_dual(jnp.asarray(x), table, spec,
                                            amp=amp)
    a_t, b_t = thp.packed_encode_bound_dual(
        _t(x), setup["pt"]["field"]["encoder"], tspec, amp=amp)
    tol = 1e-3 if amp else 1e-6
    _close(a_t, a_j, tol * float(np.abs(a_j).max()))
    _close(b_t, b_j, tol * float(np.abs(b_j).max()))
    # the noise-free encode reads the mean lanes; through the bf16
    # inference table it is the same read
    m_j = jhp.packed_encode_bound(jnp.asarray(x), table, spec, amp=True)
    m_t = thp.packed_encode_bound(
        _t(x), thp.inference_table(setup["pt"]["field"]["encoder"], tspec),
        tspec)
    _close(m_t, m_j, 1e-3 * float(np.abs(m_j).max()))
    if amp:
        _close(a_t, m_t, 1e-6 * float(np.abs(m_j).max()))


def test_init_dual_layout():
    spec = thp.PackedGridSpec(num_levels=2, level_dim=2, base_resolution=8,
                              log2_bricks=6)
    t = spec.init_dual(torch.Generator().manual_seed(0), std_a=1e-2,
                       std_b=1e-3, mean_b=-8.0)
    rw = spec.row_width
    assert tuple(t.shape) == (spec.table_rows, spec.dual_storage_width)
    assert float(t[:, :rw].abs().max()) <= 1e-2
    assert float((t[:, rw:] + 8.0).abs().max()) <= 1e-3 + 1e-6


def test_normal_net_matches(setup):
    cfg_j, cfg_t = setup["cj"].field.normal_cfg, setup["ct"].field.normal_cfg
    assert cfg_t.phi_embed_dim == cfg_j.phi_embed_dim
    rng = np.random.default_rng(2)
    z = rng.normal(size=(N, cfg_j.z_dim)).astype(np.float32)
    xe = rng.normal(size=(N, cfg_j.x_dim)).astype(np.float32)
    ph = rng.normal(size=(N, cfg_j.phi_embed_dim)).astype(np.float32)
    tbn = rng.normal(size=(N, 3, 3)).astype(np.float32)
    nj, nt = setup["pj"]["field"]["normal"], setup["pt"]["field"]["normal"]
    _close(tnn.apply(nt, _t(z), _t(xe), cfg_t, phi_embed=_t(ph)),
           jnn.apply(nj, jnp.asarray(z), jnp.asarray(xe), cfg_j,
                     phi_embed=jnp.asarray(ph)), 1e-5)
    _close(tnn.apply(nt, _t(z), _t(xe), cfg_t, phi_embed=_t(ph), tbn=_t(tbn)),
           jnn.apply(nj, jnp.asarray(z), jnp.asarray(xe), cfg_j,
                     phi_embed=jnp.asarray(ph), tbn=jnp.asarray(tbn)), 1e-5)
    th_t, ph_t = tnn.apply(nt, _t(z), _t(xe), cfg_t, phi_embed=_t(ph),
                           return_rot_angles=True)
    th_j, ph_j = jnn.apply(nj, jnp.asarray(z), jnp.asarray(xe), cfg_j,
                           phi_embed=jnp.asarray(ph), return_rot_angles=True)
    _close(th_t, th_j, 1e-5)
    _close(ph_t, ph_j, 1e-5)
    p_sur = setup["x"]
    for amp in (False, True):
        e_j = jnn.phi_embedding(nj, jnp.asarray(p_sur), cfg_j, amp=amp)
        e_t = tnn.phi_embedding(nt, _t(p_sur), cfg_t, amp=amp)
        _close(e_t, e_j, (1e-3 if amp else 1e-6) * float(np.abs(e_j).max()))


def test_sh_light_matches(setup):
    cfg_j, cfg_t = setup["cj"].sh_cfg, setup["ct"].sh_cfg
    rng = np.random.default_rng(3)
    geo = rng.normal(size=(N, cfg_j.input_dim)).astype(np.float32)
    nrm, view = setup["v"], -setup["x"] / np.linalg.norm(
        setup["x"], axis=-1, keepdims=True)
    lj, lt = setup["pj"]["light"], setup["pt"]["light"]
    env = np.random.default_rng(4).normal(size=(16, 1)).astype(np.float32)
    lj = dict(lj, env_shs=lj["env_shs"] + jnp.asarray(env))
    lt = dict(lt, env_shs=lt["env_shs"] + _t(env))
    for spec in (True, False):
        cj = jsh.SHLightConfig(**dict(cfg_j.__dict__, use_specular=spec))
        ct = tsh.SHLightConfig(**dict(cfg_t.__dict__, use_specular=spec))
        out_j = jsh.apply(lj, jnp.asarray(geo), jnp.asarray(nrm),
                          jnp.asarray(view), cj, normals_secondary=None)
        out_t = tsh.apply(lt, _t(geo), _t(nrm), _t(view), ct)
        for a, b, name in zip(out_t, out_j, ("full", "spec", "diff", "alb")):
            _close(a, b, 1e-2, msg=name)
    # an imported environment replaces the learned one (the imports'
    # own parity, with visibility probes: tests/test_torch_lights.py)
    imp = np.random.default_rng(5).normal(size=(9, 3)).astype(np.float32)
    out_j = jsh.apply(lj, jnp.asarray(geo), jnp.asarray(nrm),
                      jnp.asarray(view), cfg_j, env_import=jnp.asarray(imp))
    out_t = tsh.apply(lt, _t(geo), _t(nrm), _t(view), cfg_t,
                      env_import=_t(imp))
    for a, b, name in zip(out_t, out_j, ("full", "spec", "diff", "alb")):
        _close(a, b, 1e-2, msg="import " + name)


@pytest.mark.parametrize("noisy", [False, True])
def test_mesh_field_apply_matches(setup, noisy):
    fj_cfg, ft_cfg = setup["cj"].field, setup["ct"].field
    x = setup["x"]
    key = jax.random.PRNGKey(5)
    out_j = jmf.apply(setup["pj"]["field"], setup["sj"], jnp.asarray(x),
                      fj_cfg, key=key if noisy else None,
                      no_noise=not noisy, frames=setup["fj"])
    noise = None
    if noisy:
        noise = _t(jax.random.normal(key, (N, fj_cfg.encoder_f_out_dim)))
    out_t = tmf.apply(setup["pt"]["field"], setup["st"], _t(x), ft_cfg,
                      noise=noise, no_noise=not noisy, frames=setup["ft"])
    np.testing.assert_array_equal(_np(out_t.h_mask), np.asarray(out_j.h_mask))
    assert 0.3 < _np(out_t.h_mask).mean() < 1.0
    scale = float(np.abs(np.asarray(out_j.embed)).max())
    _close(out_t.embed, out_j.embed, 2e-2 * scale)
    _close(out_t.normal_coarse, out_j.normal_coarse, 1e-6)
    _close(out_t.normal_fine, out_j.normal_fine, 1e-2)
    if noisy:
        # the noise moved the features
        clean = tmf.apply(setup["pt"]["field"], setup["st"], _t(x), ft_cfg,
                          no_noise=True, frames=setup["ft"])
        assert float((clean.embed - out_t.embed).abs().max()) > 1e-5


def test_mesh_field_unported_raise(setup):
    """Nothing of mesh_field is left unported: mode 'none' without frames
    and the imports run (their parity tests: tests/test_torch_projection.py,
    tests/test_torch_texture.py, tests/test_torch_shape_import.py), and so
    does the vertex encoder (tests/test_torch_vertex_encoder.py), whose
    init, as JAX's, needs the feature mesh's vertex count.  Mode 'shape'
    without a 'field' import raises, naming load_field (the JAX function
    fails inside the normal net)."""
    x = _t(setup["x"][:4])
    with pytest.raises(ValueError, match="load_field"):
        tmf.apply(setup["pt"]["field"], setup["st"], x, setup["ct"].field,
                  mode="shape", no_noise=True)
    out = tmf.apply(setup["pt"]["field"], setup["st"], x, setup["ct"].field,
                    no_noise=True)
    assert out.embed.shape[0] == 4
    with pytest.raises(ValueError, match="n_feature_vertices"):
        tmf.init(torch.Generator(), tmf.MeshFieldConfig(
            encoder_type="vertex"))
    with pytest.raises(ValueError, match="n_feature_vertices"):
        jmf.init(jax.random.PRNGKey(0), jmf.MeshFieldConfig(
            encoder_type="vertex"))
    vcfg = tmf.MeshFieldConfig(encoder_type="vertex", n_feature_vertices=10)
    p = tmf.init(torch.Generator(), vcfg)
    assert tuple(p["features_v"].shape) == (10, vcfg.feature_dim)


def _assert_sigma_close(s_t, s_j):
    s_t, s_j = _np(s_t), np.asarray(s_j)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-2, atol=1e-2)
    assert (s_j > 0).mean() > 0.3


@pytest.mark.parametrize("infer_tables", [False, True])
def test_curved_forward_and_two_phase_match(setup, infer_tables):
    cj, ct = setup["cj"], setup["ct"]
    x, v = setup["x"], setup["v"]
    pt = curved_infer_params(setup["pt"], ct) if infer_tables \
        else setup["pt"]
    rt_j = jmf.FieldRuntime.default()
    s_j, c_j, _ = jcf.forward(setup["pj"], setup["sj"], jnp.asarray(x),
                              jnp.asarray(v), cj, rt_j,
                              frames=setup["fj"])
    s_t, c_t, ex = tcf.forward(pt, setup["st"], _t(x), _t(v), ct,
                               tmf.FieldRuntime.default(),
                               frames=setup["ft"])
    assert ex == {}
    _assert_sigma_close(s_t, s_j)
    _close(c_t, c_j, 1e-2)
    assert np.asarray(c_j).std() > 1e-2

    sa_j, aux_j = jcf.sigma_with_aux(setup["pj"], setup["sj"],
                                     jnp.asarray(x), jnp.asarray(v), cj,
                                     rt_j, frames=setup["fj"])
    sa_t, aux_t = tcf.sigma_with_aux(pt, setup["st"], _t(x), _t(v), ct,
                                     tmf.FieldRuntime.default(),
                                     frames=setup["ft"])
    _assert_sigma_close(sa_t, sa_j)
    np.testing.assert_array_equal(_np(aux_t["h_mask"]),
                                  np.asarray(aux_j["h_mask"]))
    _close(aux_t["embed"], aux_j["embed"],
           2e-2 * float(np.abs(np.asarray(aux_j["embed"])).max()))
    _close(aux_t["geo"], aux_j["geo"], 2e-2, rtol=2e-2)
    # the colour phase on JAX's aux, so only color_from_aux differs
    aux_in = {k: _t(a) for k, a in aux_j.items()}
    col_t = tcf.color_from_aux(pt, setup["st"], _t(x), _t(v), aux_in, ct,
                               tmf.FieldRuntime.default(), setup["ft"])
    col_j = jcf.color_from_aux(setup["pj"], setup["sj"], jnp.asarray(x),
                               jnp.asarray(v), aux_j, cj, rt_j, setup["fj"])
    _close(col_t, col_j, 1e-2)
    # one pass and two phases shade alike
    _close(col_t, c_t, 1e-2)


def test_density_matches(setup):
    cj, ct = setup["cj"], setup["ct"]
    x = setup["x"]
    s_j, g_j = jcf.density(setup["pj"], setup["sj"], jnp.asarray(x), cj,
                           frames=setup["fj"])
    s_t, g_t = tcf.density(setup["pt"], setup["st"], _t(x), ct,
                           frames=setup["ft"])
    _assert_sigma_close(s_t, s_j)
    _close(g_t, g_j, 2e-2, rtol=2e-2)


def test_curved_unported_raise(setup):
    """Mode 'shape' without a 'field' import raises (naming load_field);
    the viewer's options (a visual mode, the light rotation, an imported
    environment) and the SG and Envmap light models, once raising, run:
    with the identity rotation the frame is the plain one, and each light
    model's init tree has the JAX init's shapes (their parity:
    tests/test_torch_relight.py)."""
    ct = setup["ct"]
    args = (setup["pt"], setup["st"], _t(setup["x"][:4]), _t(setup["v"][:4]),
            ct)
    with pytest.raises(ValueError, match="load_field"):
        tcf.forward(*args, mode="shape")
    frames = {k: v[:4] for k, v in setup["ft"].items()}
    base = tcf.forward(*args, frames=frames)[1]
    for kw in (dict(visual_mode="UV"),
               dict(euler_rot=torch.eye(3)),
               dict(light_import={"env_import": torch.zeros((9, 3))})):
        out = tcf.forward(*args, frames=frames, **kw)[1]
        assert out.shape == (4, 3) and torch.isfinite(out).all(), kw
    assert torch.equal(tcf.forward(*args, frames=frames,
                                   euler_rot=torch.eye(3))[1], base)
    for light in ("SG", "Envmap"):
        kw = dict(light_model=light, field=ct.field, hidden_dim=16,
                  geo_feat_dim=7)
        pt = tcf.init(torch.Generator(), tcf.CurvedFieldConfig(**kw))
        pj = jcf.init(jax.random.PRNGKey(0), jcf.CurvedFieldConfig(**dict(
            kw, field=jmf.MeshFieldConfig(**FIELD))))
        assert jax.tree.map(lambda a: tuple(a.shape), pt["light"],
                            is_leaf=torch.is_tensor) == jax.tree.map(
            lambda a: tuple(a.shape), pj["light"]), light


@pytest.mark.parametrize("dir_degree", [4, 0])
def test_colour_net_forward_matches(setup, dir_degree):
    """Without a light model the colour is an MLP over the SH-encoded
    reflection direction (or the geo features alone)."""
    kw = dict(MODEL, light_model="None", dir_degree=dir_degree)
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **kw)
    ct = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **kw)
    p = jax.tree.map(np.array, jcf.init(jax.random.PRNGKey(2), cj))
    p["field"]["encoder"][:, :cj.field.feature_spec.row_width] *= 1e4
    assert "color_net" in p and "light" not in p
    x, v = setup["x"], setup["v"]
    s_j, c_j, _ = jcf.forward(jax.tree.map(jnp.asarray, p), setup["sj"],
                              jnp.asarray(x), jnp.asarray(v), cj,
                              frames=setup["fj"])
    s_t, c_t, _ = tcf.forward(params_from_jax(p, device="cpu"), setup["st"],
                              _t(x), _t(v),
                              ct, frames=setup["ft"])
    _assert_sigma_close(s_t, s_j)
    _close(c_t, c_j, 1e-2)
    assert np.asarray(c_j).std() > 1e-2

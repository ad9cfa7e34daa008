"""The light models of the PyTorch port vs the JAX package: the SG light
(``models/lights/sg.py``: init, the hemisphere integral, the lambda
trick, PhySG shading with and without BRDF blending, apply with an
imported or white light, the Adam fit of lobes to an environment and its
rasterisation), the Envmap light (``models/lights/envmap.py``: probe
directions, init, apply with visibility, an imported grid and gamma) and
the SH light's imported environments (``models/lights/sh.py``: the zonal
rotation, the least-squares product fit, visibility probes, apply on an
imported environment with and without them, the image reader and the SH
projection).

Same numpy inputs into both; params from the JAX init, converted.  Every
random draw a JAX function makes from its key (the SG fit's initial
sharpness, the product fit's directions) is handed to the port.

Tolerances, each with its reason:
- host arrays (Fibonacci lobes, probe directions, solid angles, the
  roughness init, the image reader): bit for bit (the same numpy code);
- light maths (energy, hemisphere integral, lambda trick, the Envmap
  sums, zonal rotation, SH projection): 1e-6 relative to the output's
  largest entry (the same f32 formulas; XLA fuses and orders sums
  differently); the SG rasterisation 1e-5 (exp(lambda (d . l - 1))
  multiplies the dot product's rounding by lambda, up to ~60 here);
- PhySG shading: 5e-5 of the largest entry (``render_with_sg``), 1e-4
  through the albedo MLP (the SG ``apply``).  Its specular and diffuse
  terms each subtract two nearly equal SG integrals (p_mu H(p) - f_mu
  alpha H(f)) whose sharpness reaches 1e4 at grazing views, so a
  last-bit difference is amplified: each package is ~4e-4 of the
  largest entry from the f64 evaluation, and they differ by 1.3e-5
  (measured);
- Envmap and SH apply (the BRDF MLPs on the same features): 1e-5 of the
  largest entry (bf16 operands on both sides; measured at the f32
  level);
- the gradients of the shading, with edge rows (nh = 0, n . v = 0, a
  normal opposite a lobe): finite in the port, within 1e-4 of each
  input's largest gradient; finite in JAX but where its SG gradient in
  the normal and view is NaN (a view facing away from the normal, see
  the test);
- the SG fit: 1e-4 of the lobe parameters' largest entry after 500 Adam
  steps (optax and torch's Adam round their updates differently);
- the product fit and the visibility probes: 1e-5 (least squares by
  other drivers: XLA's SVD, LAPACK's gelsy; the port solves every probe
  in one call); SH apply on those probes 5e-5 (the probes' 1e-5 through
  the irradiance sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.models.lights import envmap as jenv
from nerf_texture_tpu.models.lights import sg as jsg
from nerf_texture_tpu.models.lights import sh as jsh
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.models.lights import envmap as tenv
from nerf_texture_tpu_torch.models.lights import sg as tsg
from nerf_texture_tpu_torch.models.lights import sh as tsh


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (see
    tests/test_torch_training_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, want, rtol, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rtol * scale,
                               err_msg=msg)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _shading_inputs(n=400, seed=0):
    """Normals, view directions and geo features, with edge rows: a view
    perpendicular to the normal (n . v = 0), a normal opposite the view,
    and normals along and against the first Fibonacci lobe."""
    rng = np.random.default_rng(seed)
    nrm, view = _unit(rng, n), _unit(rng, n)
    lobe = jsg.fibonacci_sphere(4)[0]
    nrm[0] = [0.0, 0.0, 1.0]
    view[0] = [1.0, 0.0, 0.0]
    nrm[1], view[1] = [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]
    nrm[2], nrm[3] = lobe, -lobe
    nrm[2:4] /= np.linalg.norm(nrm[2:4], axis=-1, keepdims=True)
    geo = rng.normal(size=(n, 7)).astype(np.float32)
    return nrm, view, geo


def test_host_arrays_bit_for_bit():
    for n in (1, 4, 8, 32):
        np.testing.assert_array_equal(tsg.fibonacci_sphere(n),
                                      jsg.fibonacci_sphere(n))
    for h, w in ((8, 8), (16, 16), (5, 9)):
        for a, b in zip(tenv.gen_light_dirs(h, w), jenv.gen_light_dirs(h, w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsh._VIS_ZONAL, jsh._VIS_ZONAL)
    # one device copy of the probe directions per (res, device)
    d1, a1 = tenv.light_dirs(8, "cpu")
    d2, _ = tenv.light_dirs(8, torch.device("cpu"))
    assert d1 is d2 and tuple(d1.shape) == (64, 3) and tuple(a1.shape) \
        == (64, 1)
    for cfg in (dict(), dict(num_brdf_sgs=2, white_light=False,
                             white_specular=False)):
        a = tsg.init(torch.Generator().manual_seed(0),
                     tsg.SGLightConfig(input_dim=7, num_lgt_sgs=4, **cfg))
        b = jsg.init(jax.random.PRNGKey(0),
                     jsg.SGLightConfig(input_dim=7, num_lgt_sgs=4, **cfg))
        assert set(a) == set(b)
        for k in a:
            shapes = jax.tree.map(lambda x: tuple(x.shape), b[k])
            assert jax.tree.map(lambda x: tuple(x.shape), a[k],
                                is_leaf=torch.is_tensor) == shapes, k
        np.testing.assert_array_equal(_np(a["roughness"]),
                                      np.asarray(b["roughness"]))
        np.testing.assert_array_equal(_np(a["lgt_sgs"][:, :3]),
                                      np.asarray(b["lgt_sgs"][:, :3]))
        # both normalise the lobes' total energy to 2 pi
        for lg in (a["lgt_sgs"], _t(b["lgt_sgs"])):
            e = tsg.sg_energy(None, lg[:, 3:4], lg[:, 4:])
            np.testing.assert_allclose(_np(e.sum(0)), 2 * np.pi, rtol=1e-5)
    e = tenv.init(torch.Generator().manual_seed(0),
                  tenv.EnvmapLightConfig(input_dim=7, env_res=8))
    assert tuple(e["env_map"].shape) == (8, 8, 1)
    assert [tuple(l["w"].shape) for l in e["brdf_net"]] == [(7, 64),
                                                           (64, 64), (64, 5)]


def test_sg_maths_match_jax():
    rng = np.random.default_rng(1)
    lam = np.concatenate([rng.uniform(0.01, 300, 500),
                          [0.0315, 1e-3]]).astype(np.float32)[:, None]
    cosb = np.concatenate([rng.uniform(-1, 1, 500),
                           [0.0, -1.0]]).astype(np.float32)[:, None]
    _rel(tsg.hemisphere_int(_t(lam), _t(cosb)),
         jsg.hemisphere_int(jnp.asarray(lam), jnp.asarray(cosb)), 1e-6)
    mus = rng.uniform(0.1, 2, (502, 3)).astype(np.float32)
    _rel(tsg.sg_energy(None, _t(lam), _t(mus)),
         jsg.sg_energy(None, jnp.asarray(lam), jnp.asarray(mus)), 1e-6)
    l1, l2 = _unit(rng, 502), _unit(rng, 502)
    l2[-1] = -l1[-1]                          # dot = -1
    lam2 = (lam * 10 + 1).astype(np.float32)
    got = tsg.lambda_trick(_t(l1), _t(lam), _t(mus), _t(l2), _t(lam2),
                           _t(mus))
    want = jsg.lambda_trick(*(jnp.asarray(a) for a in (l1, lam, mus, l2,
                                                       lam2, mus)))
    for g, w in zip(got, want):
        _rel(g, w, 1e-6)


@pytest.mark.parametrize("blend", [False, True])
def test_render_with_sg_and_its_edges(blend):
    nrm, view, _ = _shading_inputs()
    rng = np.random.default_rng(2)
    K = 2 if blend else 1
    lgt = np.concatenate([jsg.fibonacci_sphere(4),
                          rng.uniform(5, 60, (4, 1)),
                          rng.uniform(0.1, 2, (4, 3))], -1).astype(np.float32)
    spec = rng.uniform(0.2, 0.8, (K, 3)).astype(np.float32)
    rough = rng.uniform(0.3, 0.7, (K, 1)).astype(np.float32)
    alb = rng.uniform(0, 1, (len(nrm), 3)).astype(np.float32)
    bw = (rng.dirichlet(np.ones(K), len(nrm)).astype(np.float32)
          if blend else None)

    def jfn(lg, n, v, r):
        out = jsg.render_with_sg(lg, jnp.asarray(spec), r, jnp.asarray(alb),
                                 n, v, None if bw is None
                                 else jnp.asarray(bw))
        return sum(jnp.sum(o) for o in out[:3]), out

    (_, want), gj = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jnp.asarray(lgt), jnp.asarray(nrm), jnp.asarray(view),
        jnp.asarray(rough))
    ins = [_t(a).requires_grad_(True) for a in (lgt, nrm, view, rough)]
    got = tsg.render_with_sg(ins[0], _t(spec), ins[3], _t(alb), ins[1],
                             ins[2], None if bw is None else _t(bw))
    for g, w in zip(got, want):
        _rel(g, w, 5e-5)
    sum(o.sum() for o in got[:3]).backward()
    # JAX's gradient in the normal and view is NaN on rows where the
    # view faces away from the normal (n . v <= 0 makes the half vector
    # zero in f32 -- on most such rows -- and jnp.linalg.norm's gradient
    # at zero is NaN); torch's norm gradient is 0 there (ROADMAP Queue
    # 3).  On the front-facing rows, and in the light and roughness
    # everywhere, both are finite and agree.
    back = np.sum(nrm * view, -1) <= 0
    for name, t, w in zip(("lgt", "normal", "view", "rough"), ins, gj):
        w = np.asarray(w)
        assert torch.isfinite(t.grad).all(), name
        if name in ("normal", "view"):
            nan = ~np.isfinite(w).all(-1)
            assert nan[back].mean() > 0.5 and not nan[~back].any()
            _rel(t.grad[~back], w[~back], 1e-4, msg=name)
        else:
            assert np.isfinite(w).all(), name
            _rel(t.grad, w, 1e-4, msg=name)


def _sg_params(**cfg):
    cj = jsg.SGLightConfig(input_dim=7, num_lgt_sgs=4, **cfg)
    p = jax.tree.map(np.asarray, jsg.init(jax.random.PRNGKey(3), cj))
    return cj, tsg.SGLightConfig(input_dim=7, num_lgt_sgs=4, **cfg), p


@pytest.mark.parametrize("cfg", [dict(), dict(num_brdf_sgs=2,
                                             white_light=False,
                                             white_specular=False)])
def test_sg_apply_matches_jax(cfg):
    cj, ct, p = _sg_params(**cfg)
    nrm, view, geo = _shading_inputs(seed=3)
    want = jsg.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(geo),
                     jnp.asarray(nrm), jnp.asarray(view), cj)
    got = tsg.apply(params_from_jax(p, device="cpu"), _t(geo), _t(nrm),
                    _t(view), ct)
    for g, w in zip(got, want):
        _rel(g, w, 1e-4)
    # an imported white light (5 columns) replaces the learned lobes
    imp = np.asarray(p["lgt_sgs"][:, :5] * 1.5, np.float32)
    want = jsg.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(geo),
                     jnp.asarray(nrm), jnp.asarray(view), cj,
                     lgt_sgs_import=jnp.asarray(imp))
    got = tsg.apply(params_from_jax(p, device="cpu"), _t(geo), _t(nrm),
                    _t(view), ct, lgt_sgs_import=_t(imp))
    for g, w in zip(got, want):
        _rel(g, w, 1e-4)


def _sky(H=16, W=32):
    """An analytic sky: a bright band near the +y pole over a blue-grey
    ground, f32 [H, W, 3]."""
    th = (np.arange(H) + 0.5) / H * np.pi
    ph = (np.arange(W) + 0.5) / W * 2 * np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    sun = np.exp(-((tt - 0.6) ** 2 + (pp - 2.0) ** 2) * 4.0)
    sky = 0.2 + 0.6 * np.cos(tt / 2) ** 2
    return np.stack([sky + sun, sky * 0.9 + sun, sky * 0.7 + 0.3 * sun],
                    -1).astype(np.float32)


def test_envmap_to_sg_fit_and_raster_match_jax():
    env = _sky()
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsg.envmap_to_sg(env, num_sgs=8, key=key))
    draw = np.asarray(jax.random.normal(key, (8, 1)))
    got = tsg.envmap_to_sg(env, num_sgs=8, lambda_draw=draw, device="cpu")
    assert got.shape == (8, 7)
    _rel(got, want, 1e-4)
    # the fit moved the lobes and brought the raster (on the fit's own
    # grid) closer to the map than the start
    start = np.concatenate([jsg.fibonacci_sphere(8),
                            20.0 + np.abs(draw * 20.0),
                            np.full((8, 3), env.mean() / 8)], -1)
    assert np.abs(want[:, :3] - start[:, :3]).max() > 1e-2

    def mse(lg):
        return float(torch.mean((tsg.sg_to_envmap(_t(lg), H=16, W=32)[0]
                                 - _t(env)) ** 2))

    assert mse(_np(got)) < 0.5 * mse(start)
    for lg in (want, want[:, :5]):
        r_t, d_t = tsg.sg_to_envmap(_t(lg), H=16, W=32)
        r_j, d_j = jsg.sg_to_envmap(jnp.asarray(lg), H=16, W=32)
        _rel(d_t, d_j, 1e-6)
        _rel(r_t, r_j, 1e-5)
    # the default draw comes from a seeded torch.Generator
    a = tsg.envmap_to_sg(env, num_sgs=4, iterations=2, device="cpu")
    b = tsg.envmap_to_sg(env, num_sgs=4, iterations=2, device="cpu")
    assert torch.equal(a, b)


def _env_params(res=8, white=True):
    cj = jenv.EnvmapLightConfig(input_dim=7, env_res=res, white_light=white)
    ct = tenv.EnvmapLightConfig(input_dim=7, env_res=res, white_light=white)
    p = jax.tree.map(np.asarray, jenv.init(jax.random.PRNGKey(5), cj))
    return cj, ct, p


@pytest.mark.parametrize("white", [True, False])
def test_envmap_apply_matches_jax(white):
    cj, ct, p = _env_params(white=white)
    nrm, view, geo = _shading_inputs(seed=4)
    coarse = _unit(np.random.default_rng(9), len(nrm))
    imp = np.random.default_rng(6).normal(
        size=(8, 8, 1 if white else 3)).astype(np.float32)
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    for kw in (dict(), dict(normal_coarse=coarse), dict(gamma=2.0),
               dict(normal_coarse=coarse, env_import=imp)):
        want = jenv.apply(pj, jnp.asarray(geo), jnp.asarray(nrm),
                          jnp.asarray(view), cj,
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
        got = tenv.apply(pt, _t(geo), _t(nrm), _t(view), ct,
                         **{k: _t(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})
        for g, w in zip(got, want):
            _rel(g, w, 1e-5, msg=str(kw))
    # gradients: the specular power at nh = 0 (gloss >= 1) stays finite
    def jloss(p_, n_):
        out = jenv.apply(p_, jnp.asarray(geo), n_, jnp.asarray(view), cj,
                         normal_coarse=jnp.asarray(coarse))
        return jnp.sum(out[0]) + jnp.sum(out[1])

    gp, gn = jax.grad(jloss, argnums=(0, 1))(pj, jnp.asarray(nrm))
    n_t = _t(nrm).requires_grad_(True)
    pt = params_from_jax(p, device="cpu")
    for leaf in jax.tree.leaves(pt):
        leaf.requires_grad_(True)
    out = tenv.apply(pt, _t(geo), n_t, _t(view), ct,
                     normal_coarse=_t(coarse))
    (out[0].sum() + out[1].sum()).backward()
    assert np.isfinite(np.asarray(gn)).all() and torch.isfinite(
        n_t.grad).all()
    _rel(n_t.grad, gn, 1e-4)
    _rel(pt["env_map"].grad, gp["env_map"], 1e-4)
    for a, b in zip(pt["brdf_net"], gp["brdf_net"]):
        _rel(a["w"].grad, b["w"], 1e-4)


def test_sh_import_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    nrm = _unit(rng, 300)
    _rel(tsh.zonal_rotate(tsh._VIS_ZONAL, _t(nrm)),
         jsh.zonal_rotate(jsh._VIS_ZONAL, jnp.asarray(nrm)), 1e-6)
    a = rng.normal(size=(9, 3)).astype(np.float32)
    b = rng.normal(size=(9, 3)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    dirs = np.asarray(jax.random.normal(key, (4096, 3)))
    _rel(tsh.fit_product_shs(_t(a), _t(b), dirs=dirs),
         jsh.fit_product_shs(jnp.asarray(a), jnp.asarray(b), key=key), 1e-5)
    env = _sky()
    shs_t = tsh.envmap_to_sh(env, sh_order=3)
    shs_j = jsh.envmap_to_sh(env, sh_order=3)
    assert shs_t.shape == shs_j.shape == (16, 3)
    _rel(shs_t, shs_j, 1e-6)
    for s9 in (shs_j[:9], shs_j[:9, :1]):
        ev_t, pr_t = tsh.build_visibility_probes(s9, res=4, dirs=dirs,
                                                 device="cpu")
        ev_j, pr_j = jsh.build_visibility_probes(s9, res=4)
        np.testing.assert_array_equal(_np(pr_t), np.asarray(pr_j))
        assert tuple(ev_t.shape) == (16, 9, 3)
        _rel(ev_t, ev_j, 1e-5)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray16", "gray8"])
def test_image_to_envmap_bit_for_bit(tmp_path, kind):
    import imageio.v3 as iio

    rng = np.random.default_rng(11)
    shape = {"rgb8": (8, 16, 3), "rgba8": (8, 16, 4), "gray16": (8, 16),
             "gray8": (8, 16)}[kind]
    img = (rng.integers(0, 65536, shape).astype(np.uint16) if kind == "gray16"
           else rng.integers(0, 256, shape).astype(np.uint8))
    path = str(tmp_path / f"env_{kind}.png")
    iio.imwrite(path, img)
    for white in (True, False):
        got = tsh.image_to_envmap(path, force_white=white)
        want = jsh.image_to_envmap(path, force_white=white)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if kind == "gray16":
        # the 16-bit map keeps JAX's divide-by-255 rule
        assert jsh.image_to_envmap(path, force_white=True).max() > 1.5


def test_sh_apply_on_imported_environments():
    cfg_j = jsh.SHLightConfig(input_dim=7)
    cfg_t = tsh.SHLightConfig(input_dim=7)
    p = jax.tree.map(np.asarray, jsh.init(jax.random.PRNGKey(0), cfg_j))
    nrm, view, geo = _shading_inputs(seed=5)
    coarse = _unit(np.random.default_rng(12), len(nrm))
    shs = jsh.envmap_to_sh(_sky(), sh_order=3).astype(np.float32)
    key = jax.random.PRNGKey(0)
    ev_j, pr_j = jsh.build_visibility_probes(shs[:9], res=4)
    ev_t, pr_t = tsh.build_visibility_probes(
        shs[:9], res=4, dirs=np.asarray(jax.random.normal(key, (4096, 3))),
        device="cpu")
    pj, pt = jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")
    for vis in (False, True):
        want = jsh.apply(pj, jnp.asarray(geo), jnp.asarray(nrm),
                         jnp.asarray(view), cfg_j,
                         normals_secondary=jnp.asarray(coarse),
                         shade_visibility=vis, env_import=jnp.asarray(shs),
                         env_import_vis=ev_j, probes=pr_j)
        got = tsh.apply(pt, _t(geo), _t(nrm), _t(view), cfg_t,
                        normals_secondary=_t(coarse), shade_visibility=vis,
                        env_import=_t(shs), env_import_vis=ev_t,
                        probes=pr_t)
        for g, w in zip(got, want):
            _rel(g, w, 5e-5 if vis else 1e-5, msg=f"vis={vis}")
    # the import changes the shading
    learned = tsh.apply(pt, _t(geo), _t(nrm), _t(view), cfg_t)
    assert float((learned[0] - got[0]).abs().max()) > 1e-3

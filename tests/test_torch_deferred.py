"""Deferred (per-ray) shading and the bf16 proxy corner table in the
PyTorch port vs the JAX package: ``render_rays_proxy(deferred_fns=)`` on
a toy field through every selection route, ``render_image`` with an
identity stage 2 against its own per-sample frame, the NGP's
``ngp_deferred_s1`` / ``_s2`` frames against JAX's ``Trainer.render_frame``
(with and without the learned background sphere), the baked curved
stages ``forward_baked_s1`` / ``_s2`` and the deferred baked frame
against JAX's ``CurvedTrainer.render_frame``, and ``proxy_bf16``.

Small widths: the toy shell and the NGP configs of
``tests/test_torch_render.py`` and ``tests/test_torch_ngp_background.py``;
the curved configs of ``tests/test_torch_baked.py`` (48x48 frames).  The
JAX frames reach the Pallas selections in interpret mode, their CPU
default.

Tolerances, each with its reason:
- the toy proxy render, deferred, with either selection and with two
  rounds: 1e-4 (the survivor t's agree within 1e-5,
  ``test_torch_proxy_select.py``; the stages are smooth);
- the port's deferred frame with an identity stage 2 against its
  per-sample frame: rtol 1e-4, atol 1e-5 (wsum * (sum w c / wsum) is
  sum w c up to f32 rounding; the JAX test's bounds);
- NGP and baked frames: PSNR >= 45 dB, max abs <= 5e-2, live pixels
  differing <= 0.5% (the slices' frame bounds: bf16 activations);
- the baked stages: sigma rtol + atol 1e-2, colours 1e-2, feature rows
  within 2e-2 of their max (``test_torch_baked.py``'s field bounds);
  the row width and the rows zeroed outside the shell exactly;
- a deferred baked frame against its per-sample frame, in both
  packages: mean abs < 0.02 (``tests/test_baked.py``'s relation);
- ``proxy_bf16``: the corner table bit for bit (the same f32 values,
  rounded to nearest even); the proxy render on it within 1e-4 of JAX's,
  and within ``tests/test_proxy_select.py``'s relation of the f32
  table's (mean abs < 5e-3, weights_sum 0.05).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset as JaxDS
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops.occupancy import OccupancyGrid as JaxOcc
from nerf_texture_tpu.render import baked as jbaked
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import trainer as jt
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.synthetic import shell_occupancy
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.render import baked as tbaked
from nerf_texture_tpu_torch.render import renderer as tr
from nerf_texture_tpu_torch.train import trainer as tt

from test_torch_baked import HW, _port_bake
from test_torch_baked import trainers  # noqa: F401  (module fixture)
from test_torch_ngp_background import HASH_KW, _jax_params
from test_torch_render import (NGP_KW, PROXY_KW, _assert_proxy_render_close,
                               _toy_density, _toy_field_jax,
                               _toy_field_torch, _toy_inputs)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module: beside pytest-xdist's other
    workers and JAX's thread pools a full torch pool makes every small op
    wait on the busy cores (as in tests/test_torch_checkpoint.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SELECTIONS = {"cdf": {}, "topk": dict(infer_cdf=False, infer_color_cap=8),
              "two_round": dict(proxy_samples=32, infer_color_cap=8)}


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_frames_close(img_t, img_j, ws_t, ws_j):
    """The slices' frame bounds."""
    live_t, live_j = _np(ws_t) > 0, np.asarray(ws_j) > 0
    assert 0.05 < live_j.mean() < 0.9
    assert np.mean(live_t != live_j) <= 0.005
    err = np.abs(_np(img_t) - np.asarray(img_j))
    assert err.max() <= 5e-2
    assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0


# ---------------------------------------------------------------------------
# the proxy tail on a toy field
# ---------------------------------------------------------------------------

def _toy_s1_jax(x, frames):
    sigma, rgb = _toy_field_jax(x, None)
    return sigma, jnp.concatenate([rgb, jnp.linalg.norm(x, axis=-1,
                                                        keepdims=True)], -1)


def _toy_s2_jax(fbar, d):
    return jax.nn.sigmoid(4.0 * fbar[:, :3] - 2.0 + fbar[:, 3:] * d)


def _toy_s1_torch(x, frames):
    sigma, rgb = _toy_field_torch(x, None)
    return sigma, torch.cat([rgb, torch.linalg.norm(x, dim=-1,
                                                    keepdim=True)], -1)


def _toy_s2_torch(fbar, d):
    return torch.sigmoid(4.0 * fbar[:, :3] - 2.0 + fbar[:, 3:] * d)


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_deferred_proxy_render_matches_jax(selection):
    """Deferred shading through the inverse-CDF, the top-k and the
    two-round selection against JAX's ``render_rays_proxy`` (jitted, as
    its frames run it) with the same nonlinear stage pair; the deferred
    image is not the per-sample one."""
    kw, dens, o, d, n_j, f_j = _toy_inputs(**SELECTIONS[selection])
    H = kw["grid_size"]
    cfg_j = jr.RenderConfig(**kw)
    out_j = jax.jit(lambda *a: jr.render_rays_proxy(
        _toy_field_jax, *a, cfg_j, deferred_fns=(_toy_s1_jax, _toy_s2_jax)))(
        jr.density_corner_table(jnp.asarray(dens), H), jnp.asarray(o),
        jnp.asarray(d), n_j, f_j)
    args = (tr.density_corner_table(_t(dens), H), _t(o), _t(d), _t(n_j),
            _t(f_j), tr.RenderConfig(**kw))
    out_t = tr.render_rays_proxy(_toy_field_torch, *args,
                                 deferred_fns=(_toy_s1_torch, _toy_s2_torch))
    _assert_proxy_render_close(out_t, out_j)
    per_sample = tr.render_rays_proxy(_toy_field_torch, *args)
    assert torch.equal(per_sample["weights_sum"], out_t["weights_sum"])
    assert float((per_sample["image"] - out_t["image"]).abs().max()) > 1e-3


def _toy_apply(params, x, d, static):
    return _toy_field_torch(x, d)


def _toy_s1_apply(params, x, static, frames=None):
    return _toy_field_torch(x, None)


def _toy_s2_apply(params, fbar, d, static):
    return fbar


@pytest.mark.parametrize("selection", list(SELECTIONS))
def test_identity_stage2_frame_equals_per_sample_frame(selection):
    """tests/test_frame_one_program.py's check in the port: with a
    linear stage 2 (the identity on the composited colour) the deferred
    frame is the per-sample frame, through every selection route."""
    H_GRID = 32
    dens = torch.from_numpy(_toy_density(H_GRID))
    occ = (dens[0] > 0.01).to(torch.uint8)
    pose = orbit_pose(np.pi / 2 + 0.3, 0.7, 2.0)
    H = W = 48
    intr = np.array([60.0, 60.0, W / 2, H / 2], np.float32)
    base = tr.RenderConfig(bound=1.0, cascades=1, grid_size=H_GRID,
                           max_steps=128, max_samples_infer=64,
                           ray_chunk=512, pool_mean_samples=32,
                           pool_mean_samples_infer=16, proxy_samples=0,
                           proxy_refined=16, infer_mode="proxy",
                           prepass_block=2, prepass_min_component=0)
    base = dataclasses.replace(base, **SELECTIONS[selection])
    prepass = tr.PrepassState.build(occ, base, density=dens)
    out = tr.render_image(_toy_apply, None, {}, prepass, pose, intr, H, W,
                          base)
    out_d = tr.render_image(_toy_apply, None, {}, prepass, pose, intr, H, W,
                            dataclasses.replace(base, deferred=True),
                            deferred_apply=(_toy_s1_apply, _toy_s2_apply))
    assert float(out_d["weights_sum"].max()) > 0.5
    assert out_d["chunks"] == out["chunks"] >= 2
    np.testing.assert_allclose(_np(out_d["image"]), _np(out["image"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(out_d["weights_sum"]),
                               _np(out["weights_sum"]), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the NGP
# ---------------------------------------------------------------------------

NGP_FRAME = dict(PROXY_KW, grid_size=32, ray_chunk=256)


@pytest.mark.parametrize("sphere", [False, True])
def test_ngp_deferred_frame_matches_jax_trainer(sphere):
    """``render_frame`` with ``deferred=True`` on JAX's params against
    JAX's ``Trainer.render_frame``: the packed NGP through the inverse
    CDF, and the per-corner NGP with the learned background sphere (which
    replaces bg_color) through top-k."""
    H = W = 48
    if sphere:
        kw = dict(HASH_KW, bg_radius=4.0)
        p = _jax_params(kw)
        rcfg = dict(NGP_FRAME, infer_cdf=False, infer_color_cap=8)
    else:
        kw = dict(NGP_KW)
        p = jax.tree.map(np.asarray, jngp.init(jax.random.PRNGKey(0),
                                               jngp.NGPConfig(**kw)))
        p["grid"] = p["grid"] * 1e4
        rcfg = dict(NGP_FRAME)
    rcfg["deferred"] = True
    occ = shell_occupancy(rcfg["grid_size"], device="cpu")
    ds = JaxDS(n_frames=1, H=H, W=W)
    tj = jt.Trainer(ds, jngp.NGPConfig(**kw), jr.RenderConfig(**rcfg),
                    jt.TrainConfig())
    pj = jax.tree.map(jnp.asarray, p)
    tj.state = tj.state._replace(params=pj, ema_params=pj, occ=JaxOcc(
        density=jnp.asarray(occ.density.numpy()),
        occ=jnp.asarray(occ.occ.numpy()),
        mean_density=jnp.asarray(occ.mean_density.numpy()),
        iter_density=jnp.asarray(occ.iter_density.numpy())))
    pose = orbit_pose(1.2, 0.7, 2.0)
    want = tj.render_frame(pose, use_ema=False)
    tm, pt = tngp.NGPConfig(**kw), params_from_jax(p, device="cpu")
    intr = np.asarray(ds.intrinsics, np.float32)
    got = tt.render_frame(pt, occ, pose, intr, H, W, tm,
                          tr.RenderConfig(**rcfg))
    assert got["chunks"] >= 2
    _assert_frames_close(got["image"], want["image"], got["weights_sum"],
                         want["weights_sum"])
    if sphere:
        assert _np(got["image"])[_np(got["weights_sum"]) == 0].std() > 0.02
    per_sample = tt.render_frame(pt, occ, pose, intr, H, W, tm,
                                 tr.RenderConfig(**dict(rcfg,
                                                        deferred=False)))
    assert not torch.equal(per_sample["image"], got["image"])


# ---------------------------------------------------------------------------
# the baked curved stages and frame
# ---------------------------------------------------------------------------

def test_baked_stages_match_jax(trainers):  # noqa: F811
    tj, bake_j = trainers["tj"], trainers["bake_j"]
    rng = np.random.default_rng(3)
    n = 3000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * (0.5 + rng.uniform(-0.15, 0.15, (n, 1)))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    fj = jax.jit(jbaked.anchor_frames_ext)(bake_j, trainers["ext_j"],
                                           jnp.asarray(x), jnp.asarray(valid))
    ft = tbaked.anchor_frames_ext(_port_bake(bake_j), _t(trainers["ext_j"]),
                                  _t(x), _t(valid))
    pj, pt = tj.state.params, trainers["tt"].state.params
    cj, ct = trainers["cj"], trainers["ct"]
    s_j, f_j = jax.jit(jcf.forward_baked_s1, static_argnums=3)(
        pj, bake_j, jnp.asarray(x), cj, fj)
    s_t, f_t = tcf.forward_baked_s1(pt, _port_bake(bake_j), _t(x), ct, ft)
    s_j, f_j = np.asarray(s_j), np.asarray(f_j)
    assert f_t.shape == f_j.shape
    fcfg = ct.field
    assert f_t.shape[1] == (fcfg.encoder_f_out_dim
                            + fcfg.normal_cfg.phi_embed_dim
                            + 2 * fcfg.z_multires + 1 + ct.geo_feat_dim + 12)
    zero_j = ~f_j.any(-1)
    np.testing.assert_array_equal(~_np(f_t).any(-1), zero_j)
    assert 0.05 < zero_j.mean() < 0.8
    np.testing.assert_array_equal(_np(s_t) > 0, s_j > 0)
    np.testing.assert_array_equal(s_j[zero_j], 0.0)
    np.testing.assert_allclose(_np(s_t), s_j, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(f_t), f_j, rtol=0,
                               atol=2e-2 * np.abs(f_j).max())
    # stage 2 on the same composited rows: JAX's rows of groups of 5
    # samples, averaged with random weights
    w = rng.uniform(0.0, 1.0, (n // 5, 5, 1)).astype(np.float32)
    w[:, 0] += 1.0
    fbar = (np.sum(w * f_j.reshape(-1, 5, f_j.shape[1]), 1)
            / np.sum(w, 1)).astype(np.float32)
    v = rng.normal(size=(n // 5, 3))
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    c_j = np.asarray(jax.jit(jcf.forward_baked_s2, static_argnums=3)(
        pj, jnp.asarray(fbar), jnp.asarray(v), cj,
        jmf.FieldRuntime.default()))
    c_t = tcf.forward_baked_s2(pt, _t(fbar), _t(v), ct,
                               mesh_field.FieldRuntime.default())
    assert c_t.shape == (n // 5, 3) and c_j.std() > 1e-2
    np.testing.assert_allclose(_np(c_t), c_j, rtol=0, atol=1e-2)


def test_deferred_baked_frame_matches_jax(trainers):  # noqa: F811
    """The deferred baked frame against JAX's (the port renders over
    JAX's atlas, converted, so that only the stages differ), and
    tests/test_baked.py's relation to the per-sample baked frame in both
    packages."""
    tj, tt_, bake_j = trainers["tj"], trainers["tt"], trainers["bake_j"]
    pose = np.asarray(tj.dataset.poses[1])
    saved_j, saved_t, saved_bake = tj.rcfg, tt_.rcfg, tt_._bake
    st = tt_.state
    tt_._bake = [(st.params, st.step, st.occ, 16, _port_bake(bake_j),
                  _t(trainers["ext_j"]))]
    try:
        per_j = tj.render_frame(pose, use_ema=False, baked=True)
        per_t = tt_.render_frame(pose, use_ema=False, baked=True)
        tj.rcfg = dataclasses.replace(saved_j, deferred=True)
        tt_.rcfg = dataclasses.replace(saved_t, deferred=True)
        want = tj.render_frame(pose, use_ema=False, baked=True)
        got = tt_.render_frame(pose, use_ema=False, baked=True)
    finally:
        tj.rcfg, tt_.rcfg, tt_._bake = saved_j, saved_t, saved_bake
    assert got["chunks"] >= 2 and 0 < got["live"] < HW * HW
    img_j = np.asarray(want["image"])
    assert img_j[np.asarray(want["weights_sum"]) > 0].std() > 1e-2
    _assert_frames_close(got["image"], img_j, got["weights_sum"],
                         want["weights_sum"])
    for a, b in ((per_j, want), (per_t, got)):
        diff = np.abs(_np(a["image"]) - _np(b["image"]))
        assert 0 < diff.mean() < 0.02


# ---------------------------------------------------------------------------
# proxy_bf16
# ---------------------------------------------------------------------------

def _bf16_inputs():
    """tests/test_proxy_select.py's bf16 case: a sparse gamma density
    over a 16^3 grid, 97 rays, a sinusoid field."""
    rng = np.random.default_rng(5)
    G = 16
    density = rng.gamma(0.4, 2.0, (G ** 3,)).astype(np.float32)
    density[rng.random(G ** 3) < 0.6] = 0.0
    N = 97
    o = np.tile([[0.0, 0.0, -2.0]], (N, 1)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32) * 0.2 \
        + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return G, density, o, d, np.full((N,), 1.0, np.float32), \
        np.full((N,), 3.0, np.float32)


def _sin_field_jax(x, dd):
    sigma = jnp.sum(jnp.abs(jnp.sin(3.0 * x)), -1)
    return sigma, 0.5 + 0.5 * jnp.sin(jnp.concatenate([x, dd], -1))[:, :3]


def _sin_field_torch(x, dd):
    sigma = torch.sum(torch.abs(torch.sin(3.0 * x)), -1)
    return sigma, 0.5 + 0.5 * torch.sin(torch.cat([x, dd], -1))[:, :3]


@pytest.mark.parametrize("selection", ["cdf", "topk"])
def test_proxy_bf16_table_and_render_match_jax(selection):
    G, density, o, d, nears, fars = _bf16_inputs()
    d8_j = jr.density_corner_table(jnp.asarray(density), G, bf16=True)
    d8_t = tr.density_corner_table(_t(density), G, bf16=True)
    assert d8_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        d8_t.view(torch.int16).numpy(),
        np.asarray(d8_j).view(np.int16))
    assert not torch.equal(d8_t.float(),
                           tr.density_corner_table(_t(density), G))
    kw = dict(bound=1.0, cascades=1, grid_size=G, proxy_samples=0,
              proxy_refined=32, infer_color_cap=8, proxy_bf16=True,
              infer_cdf=selection == "cdf")
    cfg_j = jr.RenderConfig(**kw)
    out_j = jax.jit(lambda *a: jr.render_rays_proxy(_sin_field_jax, *a,
                                                    cfg_j))(
        d8_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
        jnp.asarray(fars))
    cfg = tr.RenderConfig(**kw)
    args = (_t(o), _t(d), _t(nears), _t(fars), cfg)
    out_t = tr.render_rays_proxy(_sin_field_torch, d8_t, *args)
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(_np(out_t[k]), np.asarray(out_j[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(_np(out_t["counts"]),
                                  np.asarray(out_j["counts"]))
    # JAX's relation to the f32 table
    f32 = tr.render_rays_proxy(_sin_field_torch, tr.density_corner_table(
        _t(density), G), *args)
    assert float((out_t["image"] - f32["image"]).abs().mean()) < 5e-3
    np.testing.assert_allclose(_np(out_t["weights_sum"]),
                               _np(f32["weights_sum"]), atol=0.05)
    # the prepass state builds the table that the config asks for
    occ = torch.from_numpy((density > 0.01).astype(np.uint8))
    dens = torch.from_numpy(density).reshape(1, -1)
    st = tr.PrepassState.build(occ, cfg, density=dens)
    assert torch.equal(st.dens8, d8_t)
    st32 = tr.PrepassState.build(occ, dataclasses.replace(
        cfg, proxy_bf16=False), density=dens)
    assert st32.dens8.dtype == torch.float32

"""Band-sharded NGP frames in the port (``parallel.eval.
render_image_sharded`` over 4 data ranks) vs the JAX package's on 4
virtual CPU devices (the curved model's band frames:
``tests/test_torch_parallel_frames_curved.py``).

NGP frames (seeded weights, a fixture density shell, 24 x 24):
- the chunk fallback at ``tests/test_prepare_seams_eval.py:62``'s
  config (no density grid), within 1e-4 of JAX's (that test's bound);
- the band path (the density grid, the proxy path with the
  survivor-selection kernel's plain twin in every chunk of every band)
  at ``prepass_block=1``, within 1e-4 of JAX's: the bands' block rays,
  spans and live rays are the frame's;
- the band path at ``prepass_block=4`` with the tau carve: the frame
  bounds (>= 45 dB, max abs <= 5e-2, live mismatch <= 0.5%) against
  JAX's single-device frame, and within 1e-4 of the port's single-rank
  frame.  The port's band prepass covers one block row beyond each edge
  of the band, so its carve's 3x3 block neighbourhoods are the whole
  frame's (JAX's band clamps them at the band's edges: its band frame
  is not held here).
- every band frame of the band path within 1e-4 of the port's
  single-rank ``render_image``;
- a deferred band frame (the NGP's deferred stages, block 4 with the
  tau carve) at data 2 within 1e-4 of the port's single-rank deferred
  frame;
- at a ray chunk of 72 (no band's or frame's live count a multiple of
  it), the per-sample and the deferred band frames at data 2 equal the
  single-rank frame bit for bit: every chunk holds 72 rays (the last
  padded with the last live ray, as in JAX), so a ray's MLP rows go
  through matrix products of one shape whichever chunk holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks as R
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset as JaxDS
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.parallel import sharding as jsh
from nerf_texture_tpu.parallel.eval import (
    render_image_sharded as jax_render_sharded)
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train.trainer import ngp_field_apply as jax_ngp_apply
from nerf_texture_tpu_torch.data.synthetic import shell_occupancy
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.utils.metrics import psnr

NGP = dict(bound=1.0, num_levels=4, level_dim=2, log2_bricks=10,
           desired_resolution=64, hidden_dim=32, hidden_dim_color=32)
SEAMS = dict(bound=1.0, cascades=1, grid_size=16, max_steps=32,
             max_samples_infer=16, ray_chunk=288, pool_mean_samples=8,
             pool_mean_samples_infer=8, prepass_block=1)
BANDS = dict(SEAMS, proxy_samples=0, proxy_refined=8, infer_color_cap=4,
             prepass_tau_cull=0.0)
CASES = {"chunks": dict(SEAMS), "band1": dict(BANDS),
         "band4": dict(BANDS, prepass_block=4, prepass_tau_cull=0.1)}
HW = 24
# a ray chunk that divides no band's live count nor the frame's
PADDED_CHUNK = 72
PADDED = {"band4_c72": False, "band4_c72_deferred": True}

def _ngp_cases():
    ds = JaxDS(n_frames=1, H=HW, W=HW)
    params = jax.tree.map(np.asarray,
                          jngp.init(jax.random.PRNGKey(0),
                                    jngp.NGPConfig(**NGP)))
    shell = shell_occupancy(16, device="cpu")
    dens = shell.density.numpy()
    occ_full = np.ones((16 ** 3,), np.uint8)
    out = {}
    for name, kw in CASES.items():
        band = name != "chunks"
        out[name] = dict(
            mcfg=tngp.NGPConfig(**NGP), rcfg=RenderConfig(**kw),
            params=params, pose=np.asarray(ds.poses[0]),
            intr=np.asarray(ds.intrinsics, np.float32), H=HW, W=HW,
            occ=shell.occ.numpy() if band else occ_full,
            density=dens if band else None)
    return out


def _jax_frames(cases):
    mesh = jsh.make_mesh(data=4, model=1, devices=jax.devices()[:4])
    rep = jsh.replicated(mesh)
    out = {}
    for name, c in cases.items():
        params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]), rep)
        dens = (None if c["density"] is None
                else jax.device_put(jnp.asarray(c["density"]), rep))
        occ = jax.device_put(jnp.asarray(c["occ"]), rep)
        if name == "band4":          # JAX's single-device frame
            res = jr.render_image(
                jax_ngp_apply, jngp.NGPConfig(**NGP), c["params"],
                jnp.asarray(c["occ"]), c["pose"], c["intr"], HW, HW,
                jr.RenderConfig(**CASES[name]),
                density=jnp.asarray(c["density"]))
        else:
            res = jax_render_sharded(
                jax_ngp_apply, jngp.NGPConfig(**NGP), params, occ,
                c["pose"], c["intr"], HW, HW, jr.RenderConfig(**CASES[name]),
                mesh, density=dens)
        out[name] = {"image": np.asarray(res["image"]),
                     "weights_sum": np.asarray(res["weights_sum"])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _ngp_cases()
    tmp = tmp_path_factory.mktemp("ranks")
    ranks = R.start_ranks(R.render_job, 4, {"cases": cases}, tmp)
    band4 = cases["band4"]
    deferred = R.start_ranks(R.render_job, 2, {"cases": {
        "band4_deferred": {**band4, "rcfg": RenderConfig(
            **dict(CASES["band4"], deferred=True))},
        **{name: {**band4, "rcfg": RenderConfig(
            **dict(CASES["band4"], ray_chunk=PADDED_CHUNK, deferred=d))}
           for name, d in PADDED.items()}}}, tmp)
    want = _jax_frames(cases)
    return {"jax": want, "ngp": ranks.wait(), "deferred": deferred.wait()}


@pytest.mark.parametrize("name", list(CASES))
def test_ngp_sharded_frame_matches_jax(runs, name):
    ranks, want = runs["ngp"], runs["jax"][name]
    got = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name]["image"], got["image"])
    assert float(want["weights_sum"].max()) > 0.05
    if name == "band4":
        lit_g = got["weights_sum"] > 0
        lit_w = want["weights_sum"] > 0
        assert psnr(got["image"], want["image"]) >= 45.0
        assert float(np.abs(got["image"] - want["image"]).max()) <= 5e-2
        assert np.mean(lit_g != lit_w) <= 0.005
    else:
        np.testing.assert_allclose(got["image"], want["image"], atol=1e-4)
        np.testing.assert_allclose(got["weights_sum"], want["weights_sum"],
                                   atol=1e-4)
    if "single" in got:
        np.testing.assert_allclose(got["image"], got["single"], atol=1e-4)
    assert got["chunks"] > 0


def test_ngp_deferred_band_frame_matches_single_rank(runs):
    ranks = runs["deferred"]
    got = ranks[0]["band4_deferred"]
    np.testing.assert_array_equal(ranks[1]["band4_deferred"]["image"],
                                  got["image"])
    assert float(got["weights_sum"].max()) > 0.05 and got["chunks"] > 0
    np.testing.assert_allclose(got["image"], got["single"], atol=1e-4)
    # deferred: not the per-sample band frame of the same view (the
    # seeded features are near zero, so only a little off)
    assert np.abs(got["image"] - runs["ngp"][0]["band4"]["image"]).max() > 0


@pytest.mark.parametrize("name", list(PADDED))
def test_padded_band_frames_equal_the_single_rank_frame(runs, name):
    ranks = runs["deferred"]
    got = ranks[0][name]
    np.testing.assert_array_equal(ranks[1][name]["image"], got["image"])
    assert got["chunks"] >= 2 and got["single_live"] % PADDED_CHUNK != 0
    assert float(got["weights_sum"].max()) > 0.05
    np.testing.assert_array_equal(got["image"], got["single"])

"""JAX references and payloads of the curved model's multi-rank tests
(``tests/test_torch_parallel_curved*.py``): ``tests/test_parallel.py::
_curved_setup``'s configuration, its initial state and each step's
draws, and JAX's ``curved_train_step(mesh=)`` runs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_ranks as R
from nerf_texture_tpu.data.rays import sample_ray_indices as jax_sample
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.parallel import sharding as jsh
from nerf_texture_tpu.parallel.train import (
    shard_curved_state as jax_shard_curved)
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=32,
              max_samples_train=16, pool_mean_samples=8)
TRAIN = dict(lr=5e-3, total_steps=100, num_rays=64)
FEATURES = dict(error_map=True, optimize_camera=True)
HW, STEPS, ICO = 16, 3, 1
L = FIELD["num_levels"]


def _t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(p, "key", getattr(p, "idx", None))
                  for p in path)] = np.asarray(leaf)
    return out


def _leaves_close(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * float(np.abs(w).max()),
                                   err_msg=str(k))


def _configs(features):
    return (jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD),
                                  **MODEL),
            jr.RenderConfig(**RENDER),
            jct.CurvedTrainConfig(**TRAIN, **features),
            dict(ccfg=tcf.CurvedFieldConfig(
                field=tmf.MeshFieldConfig(**FIELD), **MODEL),
                rcfg=RenderConfig(**RENDER),
                tcfg=tct.CurvedTrainConfig(**TRAIN, **features)))


def _batch(key, frame, tcfg):
    """The draws JAX's curved step takes from ``key``, as a CurvedBatch."""
    k_pix, k_perturb, k_bg, k_noise, _ = jax.random.split(key, 5)
    n = tcfg.num_rays
    rows = tct.noise_rows(RenderConfig(**RENDER), n)
    inds = emap = None
    if tcfg.error_map:
        k1, k2, k3 = jax.random.split(k_pix, 3)
        emap = (_t(jax.random.uniform(k1, (128 * 128,), minval=1e-9,
                                      maxval=1.0)),
                _t(jax.random.uniform(k2, (n,))),
                _t(jax.random.uniform(k3, (n,))))
    else:
        inds = _t(jax_sample(k_pix, HW, HW, n)[0], torch.int64)
    return tct.CurvedBatch(
        frame=torch.tensor(int(frame)), inds=inds,
        u=_t(jax.random.uniform(k_perturb, (n,), jnp.float32)),
        bg=_t(jax.random.uniform(k_bg, (n, 3))),
        noise=_t(jax.random.normal(k_noise, (rows, L * FIELD["level_dim"]))),
        level=None, emap=emap)


def setup_run(features):
    """JAX's initial state of the run (tests/test_parallel.py::
    _curved_setup) and the port's payload of it: the params, the grid,
    the frames and each step's draws."""
    cj, rj, tj_cfg, cfg_t = _configs(features)
    ds = SyntheticSphereDataset(n_frames=2, H=HW, W=HW)
    tstate = jct.init_state(jax.random.PRNGKey(0), cj, rj, tj_cfg, 2)
    tstate = tstate._replace(occ=tstate.occ._replace(
        occ=jnp.ones_like(tstate.occ.occ)))
    o = tstate.occ
    payload = dict(cfg=cfg_t, params=jax.tree.map(np.asarray, tstate.params),
                   occ=tuple(np.asarray(a) for a in (o.density, o.occ,
                                                     o.mean_density,
                                                     o.iter_density)),
                   poses=np.asarray(ds.poses), images=np.asarray(ds.images),
                   intrinsics=np.asarray(ds.intrinsics, np.float32), H=HW,
                   W=HW, ico=ICO,
                   batches=[_batch(jax.random.PRNGKey(50 + i), i % 2, tj_cfg)
                            for i in range(STEPS)])
    return tstate, ds, payload


def jax_run(features, mesh_shape):
    """JAX's curved_train_step(mesh=) over 3 steps (tests/test_parallel.py::
    _run_curved): the losses, the first step's gradients (Adam's first
    moment / (1 - b1)) and the final error map."""
    cj, rj, tj_cfg, _ = _configs(features)
    tstate, ds, _ = setup_run(features)
    fstate = jmf.make_state(JaxMeshProjector(jax_icosphere(ICO, radius=0.5)))
    data, model = mesh_shape
    mesh = jsh.make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])
    tstate, fstate = jax_shard_curved(tstate, fstate, mesh)
    poses = jax.device_put(jnp.asarray(ds.poses), jsh.replicated(mesh))
    images = jax.device_put(jnp.asarray(ds.images), jsh.replicated(mesh))
    intr = jnp.asarray(ds.intrinsics)
    losses, grads1 = [], None
    for i in range(STEPS):
        tstate, m = jct.curved_train_step(
            tstate, fstate, poses, images, intr, jnp.asarray(i % 2),
            jax.random.PRNGKey(50 + i), ccfg=cj, rcfg=rj, tcfg=tj_cfg, H=HW,
            W=HW, mode="none", mesh=mesh)
        losses.append(float(m["loss"]))
        if i == 0:
            grads1 = {k: v / (1.0 - tj_cfg.adam_b1) for k, v in
                      _flat_jax(tstate.opt_state[0].mu).items()}
    return {"losses": losses, "grads1": grads1,
            "emap": np.asarray(tstate.error_map)}


def miss_payload(payload):
    """A batch whose second half (the second data rank's rows) misses
    every occupied cell: a ball of radius 0.3 is occupied, and those
    rows are corner pixels."""
    c = (np.arange(16) + 0.5) / 16 * 2 - 1
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    occ = (r < 0.3).astype(np.uint8).reshape(-1)
    dens = np.where(occ > 0, 10.0, 0.0).astype(np.float32)[None]
    n = TRAIN["num_rays"]
    rng = np.random.default_rng(3)
    centre = rng.integers(6, 10, size=(n // 2, 2))
    corner = rng.integers(0, 2, size=(n // 2, 2)) * 14 \
        + rng.integers(0, 2, size=(n // 2, 2))
    pix = np.concatenate([centre, corner])
    inds = torch.tensor(pix[:, 0] * HW + pix[:, 1])
    batches = [b._replace(inds=inds) for b in payload["batches"]]
    return dict(payload, occ=(dens, occ, np.float32(dens.mean()),
                              np.int32(0)), batches=batches)




def single_runs(payloads: dict) -> dict:
    """The port's single-rank steps (mesh=None) of each payload: the
    losses, the first step's gradients, the final error map."""
    out = {}
    for name, pay in payloads.items():
        st, fstate = R.curved_setup(pay)
        res = {}
        res["losses"] = R.curved_steps(st, fstate, pay, None, res)
        res["emap"] = R._np(st.error_map)
        out[name] = res
    return out


def check_against_jax(got: dict, want: dict):
    """The one-step bounds of tests/test_torch_curved_train.py (the
    module docstrings)."""
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    _leaves_close(got["grads1"], want["grads1"], 5e-2)


def check_against_single(ranks: list, single: dict, name: str):
    """The data-parallel run of ``name`` against the single-rank run, and
    every rank's state bit for bit (the module docstrings)."""
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-4)
    _leaves_close(got["grads1"], single["grads1"], 2.0 ** -8)
    np.testing.assert_allclose(got["emap"], single["emap"], rtol=2.0 ** -8)
    for r in ranks[1:]:
        assert r[name]["hashes"] == got["hashes"]
        np.testing.assert_array_equal(r[name]["emap"], got["emap"])
        assert r[name]["losses"] == got["losses"]

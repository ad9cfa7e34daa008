"""Checkpoints of the PyTorch port's trainers: the state round trip,
resumed training equal to unbroken training, rotation, the best
checkpoint, the resume modes, the tolerant merge against the JAX
package's, and the distillation teacher's load.

A checkpoint is a directory holding one ``torch.save`` file of the state
in the JAX state's layout; it loads with ``torch.load(weights_only=True)``.
Everything here is bit for bit on the CPU: a save, load and the same
draws must give back exactly the state that never stopped.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset as JaxDS
from nerf_texture_tpu.geometry.mesh import make_icosphere as jax_icosphere
from nerf_texture_tpu.geometry.projector import (
    MeshProjector as JaxMeshProjector)
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.render import renderer as jr
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.train import trainer as jtr
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.train import trainer as ttr

NGP = dict(bound=1.0, num_levels=4, level_dim=2, log2_bricks=10,
           desired_resolution=64, hidden_dim=32, hidden_dim_color=32)
NGP_RENDER = dict(bound=1.0, cascades=1, grid_size=32, max_steps=128,
                  max_samples_train=48, max_samples_infer=64,
                  ray_chunk=1024, pool_mean_samples=16, proxy_samples=0)
NGP_TRAIN = dict(lr=1e-2, total_steps=100, num_rays=256,
                 grid_update_interval=4)
FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=True)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
TRAIN = dict(lr=5e-3, total_steps=200, num_rays=64, grid_update_interval=4,
             optimize_camera=True, optimize_gamma=True, error_map=True)
HW = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module: beside
    pytest-xdist's other workers a full thread pool makes every small op
    wait on the busy cores (as in tests/test_torch_projection.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ngp_trainer(seed=0, workspace=None, **train):
    ds = SyntheticSphereDataset(n_frames=4, H=24, W=24)
    return ttr.Trainer(ds, tngp.NGPConfig(**NGP),
                       RenderConfig(**NGP_RENDER),
                       ttr.TrainConfig(**{**NGP_TRAIN, **train}), seed=seed,
                       device="cpu", workspace=workspace)


@pytest.fixture(scope="module")
def field_state():
    return tmf.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                        device="cpu"))


def _curved_trainer(field_state, seed=0, workspace=None, teacher=None,
                    **train):
    ds = SyntheticSphereDataset(n_frames=4, H=HW, W=HW)
    ccfg = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    return tct.CurvedTrainer(ds, field_state, ccfg, RenderConfig(**RENDER),
                             tct.CurvedTrainConfig(**{**TRAIN, **train}),
                             seed=seed, device="cpu", workspace=workspace,
                             teacher=teacher)


def _leaves(state):
    return ttr._paths(ttr.state_tree(state))


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k
    assert a.step == b.step
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0][
        "lr"]
    for p, q in zip(ttr.param_leaves(a.params), ttr.param_leaves(b.params)):
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", ["ngp", "curved"])
def test_save_load_round_trip(tmp_path, field_state, kind):
    def make(seed):
        return (_ngp_trainer(seed) if kind == "ngp"
                else _curved_trainer(field_state, seed))
    a = make(0)
    a.train(6)
    a.save_checkpoint(str(tmp_path / "ck"))
    files = os.listdir(tmp_path / "ck")
    assert files == [ttr.CKPT_FILE]
    raw = torch.load(str(tmp_path / "ck" / ttr.CKPT_FILE),
                     weights_only=True)
    assert int(raw["step"]) == 6 and int(raw["opt_state"][0]["count"]) == 6
    b = make(1)
    assert not torch.equal(ttr.param_leaves(a.state.params)[0],
                           ttr.param_leaves(b.state.params)[0])
    held = ttr.param_leaves(b.state.params)
    b.load_checkpoint(str(tmp_path / "ck"))
    _assert_same_state(a.state, b.state)
    # in place: the optimizer still holds the params
    assert all(x is y for x, y in zip(held,
                                      ttr.param_leaves(b.state.params)))
    if kind == "curved":
        assert torch.equal(a.state.error_map, b.state.error_map)
        assert (a.state.error_map != 1).any()
        assert "camera" in raw["params"] and "gammas" in raw["params"]


@pytest.mark.parametrize("kind", ["ngp", "curved"])
def test_resumed_training_equals_unbroken(tmp_path, field_state, kind):
    """k steps, save, a new trainer loads, k more with the same draws ==
    2k unbroken steps, bit for bit (refreshes at every 4th step fall on
    both sides of the break).  The unbroken trainer also trains in two
    calls of k: a call of the curved trainer draws its clustering levels
    up front."""
    def make(seed):
        return (_ngp_trainer(seed) if kind == "ngp"
                else _curved_trainer(field_state, seed))
    k = 6
    whole = make(0)
    whole.train(k)
    whole.train(k)
    first = make(0)
    first.train(k)
    first.save_checkpoint(str(tmp_path / "ck"))
    rest = make(3)
    rest.load_checkpoint(str(tmp_path / "ck"))
    # the random stream is not saved: hand over the draws
    rest.generator.set_state(first.generator.get_state())
    out = rest.train(k)
    _assert_same_state(whole.state, rest.state)
    assert rest.state.step == 2 * k and np.isfinite(out["losses"]).all()
    if kind == "curved":
        assert torch.equal(whole.state.error_map, rest.state.error_map)
        w = whole.render_frame(whole.dataset.poses[0], use_ema=False)
        r = rest.render_frame(rest.dataset.poses[0], use_ema=False)
        assert torch.equal(w["image"], r["image"])


def test_strict_load_refuses_another_tree(tmp_path, field_state):
    a = _curved_trainer(field_state, optimize_camera=False)
    a.save_checkpoint(str(tmp_path / "ck"))
    b = _curved_trainer(field_state)
    with pytest.raises(ValueError, match="camera"):
        b.load_checkpoint(str(tmp_path / "ck"))
    missing, unexpected = ttr.tolerant_load(b, str(tmp_path / "ck"))
    assert "params.camera" in missing and unexpected == []


def test_rotation_best_and_resume_modes(tmp_path):
    ws = str(tmp_path)
    tr = _ngp_trainer(workspace=ws)
    assert tr.resume("latest") == "scratch (no latest checkpoint found)"
    assert tr.resume("scratch").startswith("scratch")
    paths = []
    for _ in range(4):
        tr.train(2)
        paths.append(tr.checkpoint(max_keep=2))
    kept = sorted(d for d in os.listdir(tmp_path / "checkpoints")
                  if d.startswith("ckpt_"))
    assert kept == ["ckpt_00000006", "ckpt_00000008"]
    assert ttr.latest_checkpoint(ws) == paths[-1]
    # best: EMA-swapped params, written only on improvement
    assert tr.checkpoint_best(20.0)
    assert not tr.checkpoint_best(19.0)
    with open(tmp_path / "checkpoints" / "best.json") as f:
        meta = json.load(f)
    assert meta == {"metric": 20.0, "step": 8, "mode": "max"}
    best = ttr.read_checkpoint(ttr.best_checkpoint(ws))
    for a, b in zip(ttr.param_leaves(best["params"]),
                    ttr.param_leaves(tr.state.ema_params)):
        assert torch.equal(a, b)
    assert tr.checkpoint_best(21.0, mode="max")
    assert not ttr.save_best(tr, 22.0, ws, mode="min")
    # resume modes on fresh trainers
    for mode in ("latest", "best", paths[-2]):
        fresh = _ngp_trainer(seed=5, workspace=ws)
        said = fresh.resume(mode)
        want_step = 6 if mode == paths[-2] else 8
        assert fresh.state.step == want_step, (mode, said)
    fresh = _ngp_trainer(seed=5, workspace=ws)
    assert fresh.resume("best").startswith("best checkpoint")
    assert torch.equal(fresh.state.params["grid"],
                       tr.state.ema_params["grid"])
    # latest_model: the params only
    fresh = _ngp_trainer(seed=5, workspace=ws)
    ema_before = fresh.state.ema_params["grid"].clone()
    assert fresh.resume("latest_model").startswith("model weights")
    assert fresh.state.step == 0
    assert torch.equal(fresh.state.params["grid"], tr.state.params["grid"])
    assert torch.equal(fresh.state.ema_params["grid"], ema_before)
    # best falls back to latest where there is none
    other = str(tmp_path / "other")
    src = _ngp_trainer(workspace=other)
    src.train(2)
    src.checkpoint()
    fresh = _ngp_trainer(seed=5, workspace=other)
    assert fresh.resume("best").endswith("fell back to latest)")
    assert fresh.state.step == 2
    assert fresh.load_latest() and not fresh.load_best()


def test_curved_trainer_checkpoint_helpers(tmp_path, field_state):
    tr = _curved_trainer(field_state, workspace=str(tmp_path))
    tr.train(3)
    path = tr.checkpoint()
    assert os.path.basename(path) == "ckpt_00000003"
    assert tr.checkpoint_best(1.0)
    fresh = _curved_trainer(field_state, seed=2, workspace=str(tmp_path))
    fresh.render_frame(fresh.dataset.poses[0], use_ema=False)   # caches
    assert fresh.resume("latest").startswith("full state")
    assert fresh.state.step == 3
    a = tr.render_frame(tr.dataset.poses[1], use_ema=False)
    b = fresh.render_frame(fresh.dataset.poses[1], use_ema=False)
    assert torch.equal(a["image"], b["image"])
    assert fresh.load_best()
    assert torch.equal(fresh.state.params["field"]["encoder"],
                       tr.state.ema_params["field"]["encoder"])


# ---------------------------------------------------------------------------
# the tolerant merge against the JAX package's
# ---------------------------------------------------------------------------

def _jax_curved(camera: bool):
    cj = jcf.CurvedFieldConfig(field=jmf.MeshFieldConfig(**FIELD), **MODEL)
    tcfg = jct.CurvedTrainConfig(**{**TRAIN, "optimize_camera": camera})
    return jct.CurvedTrainer(
        JaxDS(n_frames=4, H=HW, W=HW), jmf.make_state(JaxMeshProjector(
            jax_icosphere(2, radius=0.5))), cj, jr.RenderConfig(**RENDER),
        tcfg, key=jax.random.PRNGKey(0))


def _paths_only(keys):
    return sorted(k.split(" (")[0] for k in keys)


def test_tolerant_merge_reports_the_jax_key_paths(tmp_path, field_state):
    jax_with, jax_without = _jax_curved(True), _jax_curved(False)
    jax_without.save_checkpoint(str(tmp_path / "j_without"))
    jax_with.save_checkpoint(str(tmp_path / "j_with"))
    port_with = _curved_trainer(field_state)
    port_without = _curved_trainer(field_state, optimize_camera=False)
    port_without.save_checkpoint(str(tmp_path / "t_without"))
    port_with.save_checkpoint(str(tmp_path / "t_with"))
    # a checkpoint without the camera into a camera-optimising trainer
    jm, ju = jtr.tolerant_load(jax_with, str(tmp_path / "j_without"))
    tm, tu = ttr.tolerant_load(port_with, str(tmp_path / "t_without"))
    assert jm and _paths_only(tm) == _paths_only(jm), (tm, jm)
    assert _paths_only(tu) == _paths_only(ju) == []
    assert "params.camera" in tm and "opt_state[0].mu.camera" in tm
    # and the reverse
    jm, ju = jtr.tolerant_load(_jax_curved(False), str(tmp_path / "j_with"))
    tm, tu = ttr.tolerant_load(_curved_trainer(field_state,
                                               optimize_camera=False),
                               str(tmp_path / "t_with"))
    assert ju and _paths_only(tu) == _paths_only(ju), (tu, ju)
    assert _paths_only(tm) == _paths_only(jm) == []


def test_tolerant_merge_keeps_what_the_checkpoint_lacks():
    target = {"a": torch.zeros(2), "b": [torch.ones(3), torch.ones(1)],
              "c": {"d": torch.zeros((2, 2))}}
    loaded = {"a": torch.full((2,), 5.0), "b": [torch.full((4,), 2.0)],
              "e": torch.zeros(1)}
    merged, missing, unexpected = ttr.tolerant_merge(target, loaded)
    assert torch.equal(merged["a"], torch.full((2,), 5.0))
    assert merged["b"][0] is target["b"][0]            # shape mismatch
    assert missing[0].startswith("b[0] (shape/dtype mismatch")
    assert missing[1:] == ["b[1]", "c"] and unexpected == ["e"]


# ---------------------------------------------------------------------------
# the distillation teacher
# ---------------------------------------------------------------------------

def test_load_ngp_teacher(tmp_path):
    with pytest.warns(UserWarning, match="no coarse NGP checkpoint"):
        assert tct.load_ngp_teacher(str(tmp_path), device="cpu") is None
    ngp_tr = _ngp_trainer()
    ngp_tr.train(2)
    ngp_tr.save_checkpoint(str(tmp_path / "checkpoints" / "ngp"))
    params, cfg = tct.load_ngp_teacher(str(tmp_path),
                                       tngp.NGPConfig(**NGP), device="cpu")
    assert cfg == tngp.NGPConfig(**NGP)
    for a, b in zip(ttr.param_leaves(params),
                    ttr.param_leaves(ngp_tr.state.params)):
        assert torch.equal(a, b)
    # a JAX NGP's numpy params convert to the same tree layout
    jp = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**NGP))
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(jax.tree.map(lambda t: t.numpy(), params))
    with open(tmp_path / "checkpoints" / "ngp" / ttr.CKPT_FILE, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.warns(UserWarning, match="teacher restore failed"):
        assert tct.load_ngp_teacher(str(tmp_path), device="cpu") is None

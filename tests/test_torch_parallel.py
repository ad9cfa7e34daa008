"""The port's ``parallel/`` vs the JAX package's on its virtual 8-device
CPU mesh: mesh layouts, start-up, parameter splits, and the
tensor-parallel MLPs (``utils/mlp.py``'s Megatron operators) over 2 gloo
ranks (processes of ``tests/torch_ranks.py``: a ``file://`` store, a
deadline that kills hung ranks).  The data- and tensor-parallel NGP step
is ``tests/test_torch_parallel_ngp.py``'s.

Tolerances, each with its reason:
- layouts, parameter splits and warnings exactly;
- the tensor-parallel MLP against JAX's ``apply_mlp``: <= 1% of the
  outputs off by > 1e-5 relative (tests/test_torch_ngp.py's bound of a
  rare bf16 flip: a row layer sums its partial products in another
  order), gradients within 5e-2 of each
  leaf's largest entry (bf16 cotangents); the f32 Lipschitz MLP within
  1e-5 of the largest entry.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from nerf_texture_tpu.models import curved_field as jcf
from nerf_texture_tpu.models import mesh_field as jmf
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.models import normal_net as jnn
from nerf_texture_tpu.parallel import distributed as jdist
from nerf_texture_tpu.parallel import sharding as jsh
from nerf_texture_tpu.utils import mlp as jmlp
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.parallel import (initialize_multihost, make_mesh,
                                             param_shardings)
from nerf_texture_tpu_torch.parallel import distributed as tdist
from nerf_texture_tpu_torch.parallel import sharding as tsh

NGP_KW = dict(bound=1.0, num_levels=4, level_dim=2, base_resolution=16,
              log2_hashmap_size=12, desired_resolution=64, hidden_dim=32,
              hidden_dim_color=32)
RENDER_KW = dict(bound=1.0, cascades=1, grid_size=16, max_steps=32,
                 max_samples_train=16)
TRAIN_KW = dict(lr=1e-2, total_steps=100, num_rays=128)


def _devices_ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_jax(tree):
    """{path: numpy} of a JAX tree, paths as the port's (keys, indices)."""
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


# ---------------------------------------------------------------------------
# meshes and start-up
# ---------------------------------------------------------------------------

def test_mesh_layouts_match_jax():
    for data, model in ((4, 2), (8, 1), (2, 2), (2, 1)):
        jm = jsh.make_mesh(data=data, model=model,
                           devices=jax.devices()[:data * model])
        np.testing.assert_array_equal(
            tsh.mesh_layout(data, model, data * model), _devices_ids(jm))
    np.testing.assert_array_equal(tsh.mesh_layout(None, 2, 8),
                                  _devices_ids(jsh.make_mesh(model=2)))
    for model in (1, 2, 4):
        np.testing.assert_array_equal(
            tdist.global_layout(model, 8, 8),
            _devices_ids(jdist.make_global_mesh(model=model)))
    with pytest.raises(ValueError, match="model=3"):
        jdist.make_global_mesh(model=3)
    with pytest.raises(ValueError, match="model=3"):
        tdist.global_layout(3, 8, 8)
    # two hosts of 4 ranks: the model axis stays within a host
    lay = tdist.global_layout(4, 8, 4)
    assert [set(row // 4) for row in lay] == [{0}, {1}]
    with pytest.raises(ValueError, match="intra-host"):
        tdist.global_layout(8, 8, 4)


def test_initialize_multihost_without_a_launch(monkeypatch, tmp_path):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False
    mesh = make_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(ValueError, match="WORLD_SIZE and RANK"):
        initialize_multihost()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert initialize_multihost() is False      # a world of one
    # the nccl backend (the default) on a host without a card raises, and
    # so does a mesh on the card; nothing falls back to gloo or the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            initialize_multihost(f"file://{tmp_path}/s", 2, 0)
        with pytest.raises((RuntimeError, AssertionError)):
            make_mesh(1, 1)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# parameter splits
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _trees():
    key = jax.random.PRNGKey(0)
    trees = {"ngp": jngp.init(key, jngp.NGPConfig(**NGP_KW))}
    field = dict(num_levels=3, level_dim=2, base_resolution=16,
                 desired_resolution=32, log2_bricks=9, h_threshold=0.12,
                 clustering=True)
    for light in ("SH", "SG", "Envmap"):
        trees[light] = jcf.init(key, jcf.CurvedFieldConfig(
            field=jmf.MeshFieldConfig(**field), light_model=light,
            hidden_dim=16, geo_feat_dim=7))
    trees["vertex"] = jcf.init(key, jcf.CurvedFieldConfig(
        field=jmf.MeshFieldConfig(**field, encoder_type="vertex",
                                  feature_dim=4, level_num=3,
                                  n_feature_vertices=162),
        light_model="SH", hidden_dim=16, geo_feat_dim=7))
    trees["mystery"] = {"grid": jnp.zeros((1024, 54)),
                        "field": {"encoder": jnp.zeros((2048, 16))},
                        "sigma_net": [{"w": jnp.zeros((64, 64))},
                                      {"w": jnp.zeros((64, 64))}],
                        "mystery": jnp.zeros((256, 256))}
    return trees


@pytest.mark.parametrize("model", [2, 4])
def test_param_splits_match_jax(model):
    jmesh = jsh.make_mesh(data=8 // model, model=model)
    tmesh = tsh.Mesh(ranks=tsh.mesh_layout(None, model, 8), data_index=0,
                     model_index=0, device=torch.device("cpu"))
    split = 0
    for name, tree in _trees().items():
        with warnings.catch_warnings(record=True) as rec_j:
            warnings.simplefilter("always")
            jsh._warned_paths.clear()
            want = jax.tree.map(lambda s: tuple(s.spec),
                                jsh.param_shardings(tree, jmesh))
        with warnings.catch_warnings(record=True) as rec_t:
            warnings.simplefilter("always")
            tsh._warned_paths.clear()
            got = param_shardings(params_from_jax(_jax_np(tree),
                                                  device="cpu"), tmesh)
        want_flat = {}
        for path, spec in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, tuple))[0]:
            want_flat[tuple(getattr(p, "key", getattr(p, "idx", None))
                            for p in path)] = spec
        got_flat = _flat_specs(got)
        assert got_flat == want_flat, name
        split += sum(s != () for s in got_flat.values())
        assert sorted(str(w.message) for w in rec_t) \
            == sorted(str(w.message) for w in rec_j), name
    assert split > 0


def _flat_specs(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat_specs(
            tree[k], prefix + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat_specs(x, prefix + (i,)).items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the tensor-parallel MLPs on 2 ranks
# ---------------------------------------------------------------------------

def _mlp_payload():
    k = jax.random.split(jax.random.PRNGKey(5), 8)
    rng = np.random.default_rng(0)
    pay = {"mlp": _jax_np(jmlp.init_mlp(k[0], [31, 32, 32, 3], bias=True)),
           "lip": _jax_np(jnn.init_lip_mlp(k[1], 18, 1))}
    # biases and Lipschitz bounds away from their zero / one starts
    for layer in pay["mlp"] + pay["lip"]:
        layer["b"] = rng.normal(size=layer["b"].shape).astype(np.float32)
    for layer in pay["lip"]:
        layer["c"] = np.float32(rng.uniform(0.2, 2.0))
    for name, width, out in (("mlp", 31, 3), ("lip", 18, 1)):
        pay["x_" + name] = rng.normal(size=(64, width)).astype(np.float32)
        pay["cot_" + name] = rng.normal(size=(64, out)).astype(np.float32)
    return pay


def _jax_mlp(pay):
    """JAX's outputs and gradients (inputs and every leaf) of both MLPs."""
    out = {}
    for name, apply in (("mlp", jmlp.apply_mlp), ("lip", jnn.apply_lip_mlp)):
        def f(layers, x):
            return apply(layers, x)
        layers = jax.tree.map(jnp.asarray, pay[name])
        y, vjp = jax.vjp(f, layers, jnp.asarray(pay["x_" + name]))
        gl, gx = vjp(jnp.asarray(pay["cot_" + name]))
        out[name] = {"y": np.asarray(y), "gx": np.asarray(gx),
                     "grads": {("net",) + k: v
                               for k, v in _flat_jax(gl).items()}}
    return out


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """The MLPs on 2 ranks at model 2 (started first), and JAX's."""
    pay = _mlp_payload()
    ranks = R.start_ranks(R.tp_mlp_job, 2, pay,
                          tmp_path_factory.mktemp("ranks"))
    want = _jax_mlp(pay)
    return {"mlp": ranks.wait(), "mlp_jax": want}


def test_tensor_parallel_mlps_match_apply_mlp(mlp_runs):
    ranks, want = mlp_runs["mlp"], mlp_runs["mlp_jax"]
    assert [r["initialized"] for r in ranks] == [(True, True)] * 2
    for r in ranks:
        for name in ("mlp", "lip"):
            got, ref = r[name], want[name]
            assert any(got["split"].values())
            if name == "mlp":
                off = np.abs(got["y"] - ref["y"]) \
                    > 1e-5 * np.abs(ref["y"]) + 1e-7
                assert off.mean() <= 0.01, off.mean()
                np.testing.assert_allclose(got["y"], ref["y"], rtol=1e-2,
                                           atol=1e-4)
                _leaves_close(got["grads"], ref["grads"], 5e-2)
                _leaves_close({"x": got["gx"]}, {"x": ref["gx"]}, 5e-2)
            else:
                _leaves_close({"y": got["y"]}, {"y": ref["y"]}, 1e-5)
                _leaves_close(got["grads"], ref["grads"], 1e-5)
                _leaves_close({"x": got["gx"]}, {"x": ref["gx"]}, 1e-5)


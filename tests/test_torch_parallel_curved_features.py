"""The curved model's data-parallel step in the port with the error map
and camera optimisation on (``CurvedTrainConfig(error_map=True,
optimize_camera=True)``) vs the JAX package's ``curved_train_step(mesh=)``
on a 2 x 1 mesh, and vs the port's own single-rank step; and the base
configuration's step on a batch whose second shard (the second data
rank's rows) misses every occupied cell, vs the single-rank step: the
rank with no sample joins every collective.

The configuration, draws and tolerances are those of
``tests/test_torch_parallel_curved.py``.  Each data rank renders its rows
of the batch drawn from the error map; every rank then writes the whole
batch's cells from the gathered per-ray MSE, so the maps stay equal.
"""

import numpy as np
import pytest
import torch

import torch_ranks as R
from curved_parallel_refs import (FEATURES, TRAIN, check_against_jax,
                                  check_against_single, jax_run,
                                  miss_payload, setup_run, single_runs)

HW = 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pays = {"features": setup_run(FEATURES)[2],
            "miss": miss_payload(setup_run({})[2])}
    ranks = R.start_ranks(R.curved_dp_job, 2, {"runs": {
        k: dict(p, data=2, model=1) for k, p in pays.items()}},
        tmp_path_factory.mktemp("ranks"))
    want = jax_run(FEATURES, (2, 1))
    return {"jax": want, "single": single_runs(pays), "port": ranks.wait(),
            "miss_pay": pays["miss"]}


def test_curved_dp_step_with_features_matches_jax(runs):
    check_against_jax(runs["port"][0]["features"], runs["jax"])
    np.testing.assert_allclose(runs["port"][0]["features"]["emap"],
                               runs["jax"]["emap"], rtol=1e-2)


@pytest.mark.parametrize("name", ["features", "miss"])
def test_curved_dp_step_matches_single_rank(runs, name):
    check_against_single(runs["port"], runs["single"][name], name)


def test_error_map_written_from_every_rank(runs):
    """The error map holds the cells of both ranks' rays (not only the
    rank's own), as the single-rank step writes them."""
    emap = runs["port"][1]["features"]["emap"]
    assert (emap != 1.0).sum() == (runs["single"]["features"]["emap"]
                                   != 1.0).sum() > TRAIN["num_rays"]


def test_missing_shard_has_no_samples(runs):
    """The second rank's rows of the missing-shard run march no sample,
    and the run still completes on both ranks (above)."""
    from nerf_texture_tpu_torch.data.rays import get_rays
    from nerf_texture_tpu_torch.ops.marching import (march_rays,
                                                     near_far_from_aabb)

    pay = runs["miss_pay"]
    b = pay["batches"][0]
    n = TRAIN["num_rays"]
    rays = get_rays(torch.tensor(pay["poses"][0]),
                    torch.tensor(pay["intrinsics"]), HW, HW, b.inds)
    o, d = rays["rays_o"], rays["rays_d"]
    aabb = torch.tensor([-1.0] * 3 + [1.0] * 3)
    nears, fars = near_far_from_aabb(o, d, aabb, 0.2)
    m = march_rays(o, d, torch.tensor(pay["occ"][1]), nears, fars,
                   bound=1.0, cascades=1, grid_size=16, max_steps=32,
                   max_samples=16, perturb=True, u=b.u)
    assert int(m.counts[n // 2:].sum()) == 0
    assert int(m.counts[:n // 2].sum()) > 0

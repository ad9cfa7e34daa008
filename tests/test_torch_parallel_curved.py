"""The curved model's data-parallel step in the port
(``curved_train_step(mesh=)``) vs the JAX package's on its virtual CPU
mesh, and vs the port's own single-rank step.

``tests/test_parallel.py::_curved_setup``'s configuration (3 levels, SH
light, icosphere(1, 0.5), a fully occupied 16^3 grid, 64 rays, 16 x 16
frames), 3 steps with JAX's draws (the pixel indices, jitter, background
and the feature noise of each step's key, per slot of the global pool);
the port's ranks are processes (``tests/torch_ranks.py``).  This file:
the base configuration at data 2; ``test_torch_parallel_curved_features.py``
the error map and camera optimisation and a batch whose second shard
misses every occupied cell, ``test_torch_parallel_curved_tp.py`` data 2
x model 2.

Tolerances, each with its reason:
- the port against JAX (``curved_train_step(mesh=)`` on a 2 x 1 mesh),
  tests/test_torch_curved_train.py's one-step bounds: the loss within
  1e-3 relative at each step, the first step's gradients within 5e-2 of
  each leaf's largest entry
  (bf16 table rows and activations, the -grad(sigma) target's
  cotangents; JAX's gradients from Adam's first moment after the step);
- the port's data-parallel step against its own single-rank step: the
  loss within 1e-4 relative at each step (``tests/test_parallel.py``'s
  bound), the first step's gradients within 2^-8 of each leaf's largest
  entry (each rank rounds its partial weight gradient to bf16 before the
  sum over ranks; see ``tests/test_torch_parallel.py``);
- every rank's params, Adam moments, EMA, grid and error map bit for bit;
- the error map after the steps: within 2^-8 relative of the single
  rank's (the written MSE of each ray is the same per-ray value; the
  params it was rendered with part in the last bits after step 1).
"""

import pytest

import torch_ranks as R
from curved_parallel_refs import (check_against_jax, check_against_single,
                                  jax_run, setup_run, single_runs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks start first; this process then computes JAX's
    run and the port's single-rank runs (mesh=None)."""
    pays = {"base": setup_run({})[2]}
    ranks = R.start_ranks(R.curved_dp_job, 2, {"runs": {
        k: dict(p, data=2, model=1) for k, p in pays.items()}},
        tmp_path_factory.mktemp("ranks"))
    jax_base = jax_run({}, (2, 1))
    return {"jax": {"base": jax_base}, "single": single_runs(pays),
            "port": ranks.wait()}


def test_curved_dp_step_matches_jax(runs):
    check_against_jax(runs["port"][0]["base"], runs["jax"]["base"])


def test_curved_dp_step_matches_single_rank(runs):
    check_against_single(runs["port"], runs["single"]["base"], "base")

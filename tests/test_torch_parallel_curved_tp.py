"""The curved model's step on a mesh with a model axis in the port:
``curved_train_step(mesh=)`` at data 2 x model 2 (the sigma net's and the
Lipschitz theta net's layers split over the model axis) vs the JAX
package's on a 2 x 2 mesh and vs the port's single-rank step, with
``tests/test_torch_parallel_curved.py``'s configuration, draws and
tolerances.
"""

import pytest

import torch_ranks as R
from curved_parallel_refs import (check_against_jax, check_against_single,
                                  jax_run, setup_run, single_runs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    pays = {"tp": setup_run({})[2]}
    steps = R.start_ranks(R.curved_dp_job, 4, {"runs": {
        "tp": dict(pays["tp"], data=2, model=2)}}, tmp)
    want = jax_run({}, (2, 2))
    return {"jax": want, "single": single_runs(pays), "port": steps.wait()}


def test_curved_dp_tp_step_matches_jax(runs):
    check_against_jax(runs["port"][0]["tp"], runs["jax"])


def test_curved_dp_tp_step_matches_single_rank(runs):
    check_against_single(runs["port"], runs["single"]["tp"], "tp")

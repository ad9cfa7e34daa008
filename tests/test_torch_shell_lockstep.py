"""The textured shell's coarse NGP (stage 1 of
``tests/test_parity_pipeline.py``) trained by the port and by the JAX
package in lockstep at the FAST profile, as ``scripts/shell_lockstep.py``
trains it over the whole schedule: the port starts from JAX's params and
grid and takes JAX's draws every step.  48 steps with three full grid
refreshes (steps 0, 16 and 32; the profile's TrainConfig refreshes the
whole grid every time).

Tolerances: the loss within 1e-2 relative at every step (the bound of
``tests/test_torch_train.py``'s lockstep: bf16 table rows and
activations on both sides round alike up to last-bit differences, which
Adam's eps of 1e-15 turns into slowly growing drift), and the held-out
PSNR within 0.3 dB (ROADMAP's bound for trained models).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import shell_lockstep as lock  # noqa: E402

STEPS = 48


@pytest.fixture(autouse=True)
def _four_threads():
    """Four intra-op threads: the port's step is elementwise work over the
    132,816-row table (Adam, the encode's weights), 68 s of this test on
    one thread and 34 s on four on an idle host; JAX's pools share the
    process (tests/test_torch_baked.py keeps two for its small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_shell_ngp_in_lockstep_with_jax():
    P = lock.PROFILES["FAST"]
    ds, dst, pose, gt = lock.scene(P)
    res, (lj, lt), jtr, _ = lock.ngp_lockstep(P, 0, ds, dst, pose, gt,
                                              steps=STEPS)
    lj, lt = np.asarray(lj), np.asarray(lt)
    assert len(lj) == STEPS and int(jtr.state.step) == STEPS
    assert int(jtr.state.occ.iter_density) == 3
    assert lj[-8:].mean() < 0.7 * lj[:8].mean()             # it learns
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    assert res["first_break"] is None
    assert abs(res["psnr_port"] - res["psnr_jax"]) <= 0.3, res
    assert res["psnr_jax"] > 10.0

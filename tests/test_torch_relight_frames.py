"""Imported environments and relit frames in the PyTorch port vs the JAX
package: ``CurvedTrainer.load_envmap`` (SH with visibility probes,
Envmap) against JAX's light_import, live and pool frames under an
imported light (SH, SG through ``envmap_to_sg``'s lobes, Envmap), with
the light rotated and a light mode, ``clear_envmap``, a visual-mode
frame, and the SG ``load_envmap`` quirk, at the small width of
``tests/test_torch_relight.py`` (whose setup and helpers this file
uses); 48x48 frames.

Tolerances: ``load_envmap``'s arrays 1e-5 relative (the SH projection's
and the product fit's f32 sums and least squares), the probes and the
Envmap grid exact; frames PSNR >= 45 dB, max abs <= 5e-2, live mismatch
<= 0.5% (the frame bounds of tests/test_torch_curved_render.py);
``clear_envmap``'s frame equal to the learned one bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_relight import (
    EULER, _assert_frames_close, _fit_dirs, _frame_trainers, _light_import,
    _make_setup, _np, _sky, _sky_png, _t)
from nerf_texture_tpu_torch.models.lights import sg as tsg


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (see
    tests/test_torch_training_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(request):
    return _make_setup(request.param)


@pytest.mark.parametrize("setup", ["SH", "Envmap"], indirect=True)
def test_load_envmap_matches_jax(setup, tmp_path):
    tj, tt = _frame_trainers(setup)
    path = _sky_png(tmp_path)
    assert tj.load_envmap(path) and tt.load_envmap(path,
                                                   fit_dirs=_fit_dirs())
    assert set(tt.light_import) == set(tj.light_import)
    for k, want in tj.light_import.items():
        want, got = np.asarray(want), _np(tt.light_import[k])
        assert got.shape == want.shape, k
        if k == "probes" or setup["light"] == "Envmap":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=k)
    # a missing file keeps the learned light, with a warning
    with pytest.warns(UserWarning, match="not found"):
        assert not tt.load_envmap(str(tmp_path / "none.png"))
    assert tt.light_import is not None


@pytest.mark.parametrize("setup", ["SH", "SG", "Envmap"], indirect=True)
def test_relit_frames_match_jax(setup, tmp_path):
    tj, tt = _frame_trainers(setup)
    pose = np.asarray(tj.dataset.poses[1])
    learned = tt.render_frame(pose)
    if setup["light"] == "SG":
        li = _light_import(setup)
        tj.light_import = {k: jnp.asarray(v) for k, v in li.items()}
        tt.light_import = {k: _t(v) for k, v in li.items()}
    else:
        path = _sky_png(tmp_path)
        tj.load_envmap(path)
        tt.load_envmap(path, fit_dirs=_fit_dirs())
    for parity in (False, True):
        got = tt.render_frame(pose, parity=parity)
        _assert_frames_close(got, tj.render_frame(pose, parity=parity))
    assert np.abs(_np(got["image"]) - _np(learned["image"])).max() > 1e-2
    # the light's rotation and a light mode, on the imported light
    tj.euler, tt.euler = EULER, EULER
    tj.light_visual_mode = tt.light_visual_mode = "Diffuse"
    _assert_frames_close(tt.render_frame(pose), tj.render_frame(pose))
    tj.euler = tt.euler = None
    tj.light_visual_mode = tt.light_visual_mode = "Full"
    # back to the learned light: the same frame, bit for bit
    tt.clear_envmap()
    assert tt.light_import is None
    assert torch.equal(tt.render_frame(pose)["image"], learned["image"])


@pytest.mark.parametrize("setup", ["SG"], indirect=True)
def test_visual_mode_frames_and_the_sg_envmap_quirk(setup, tmp_path):
    tj, tt = _frame_trainers(setup)
    pose = np.asarray(tj.dataset.poses[2])
    tj.visual_mode = tt.visual_mode = "Nf"
    _assert_frames_close(tt.render_frame(pose), tj.render_frame(pose))
    tj.visual_mode = tt.visual_mode = "RGB"
    # the JAX method reads a field SGLightConfig lacks; the port refuses
    path = _sky_png(tmp_path)
    with pytest.raises(AttributeError, match="num_sgs"):
        tj.load_envmap(path)
    with pytest.raises(ValueError, match="envmap_to_sg"):
        tt.load_envmap(path)
    assert tt.light_import is None
    # the SG import itself: envmap_to_sg's lobes as light_import
    lobes = tsg.envmap_to_sg(_sky(), num_sgs=6, iterations=20, device="cpu")
    tt.light_import = {"lgt_sgs_import": lobes}
    out = tt.render_frame(pose)["image"]
    assert torch.isfinite(out).all()

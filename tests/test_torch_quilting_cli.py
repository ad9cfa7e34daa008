"""The flat quilting CLI of the PyTorch port
(``patch_matching_and_quilting_torch.py``) vs the JAX package's
(``patch_matching_and_quilting.py``): both, run as subprocesses on one
``field_io.save_field`` npz at the test width, write the same
texture.npz bit for bit (the same host numpy on the same input), with
the default options and with mirroring, blending and a patch size; the
port's CLI imports neither JAX nor the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
from nerf_texture_tpu_torch.geometry.projector import MeshProjector
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.synthesis.patches import PatchSampleConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.train import field_io

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_texture.py's narrow curved config
FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
             desired_resolution=32, log2_bricks=9, h_threshold=0.12,
             clustering=False)
MODEL = dict(light_model="SH", hidden_dim=16, geo_feat_dim=7)
RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=48,
              max_samples_train=24, max_samples_infer=32, ray_chunk=256,
              pool_mean_samples=16, pool_mean_samples_infer=16,
              proxy_samples=0)
SCFG = dict(patch_size=8, max_patch_num=6, center_batch=3, pattern_rate=1 / 4)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.fixture(scope="module")
def field_npz(tmp_path_factory):
    """The patches of a seeded narrow curved field (the encoder's mean
    lanes x 1e4 and the phi grid x 1e3, so that the features vary)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ccfg = tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(**FIELD), **MODEL)
    mesh = make_icosphere(2, radius=0.5)
    tr = tct.CurvedTrainer(
        SyntheticSphereDataset(n_frames=2, H=32, W=32),
        tmf.make_state(MeshProjector(mesh, device="cpu")), ccfg,
        RenderConfig(**RENDER), tct.CurvedTrainConfig(), seed=0,
        device="cpu")
    with torch.no_grad():
        rw = ccfg.field.feature_spec.row_width
        tr.state.params["field"]["encoder"][:, :rw] *= 1e4
        tr.state.params["field"]["normal"]["phi_grid"] *= 1e3
    tr.initialize_states(1)
    path = str(tmp_path_factory.mktemp("quilt") / "field.npz")
    field_io.save_field(tr, path, mesh=mesh, scfg=PatchSampleConfig(**SCFG))
    torch.set_num_threads(n)
    return path


def _quilt(cli, field, out, *flags):
    res = subprocess.run(
        [sys.executable, str(REPO / cli), field, "--output_size", "32",
         "--out", out, *flags], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, (cli, res.stderr[-2000:])
    assert f"saved {out}" in res.stdout
    return dict(np.load(out, allow_pickle=True))


@pytest.mark.parametrize("flags", [(), ("--mirror_hor", "--mirror_vert",
                                        "--mode", "blend", "--patch_size",
                                        "4", "--seed", "3")])
def test_both_clis_write_the_same_texture(field_npz, tmp_path, flags):
    data = np.load(field_npz, allow_pickle=True)
    assert np.abs(data["patches"]).max() > 0
    want = _quilt("patch_matching_and_quilting.py", field_npz,
                  str(tmp_path / "texture_jax.npz"), *flags)
    got = _quilt("patch_matching_and_quilting_torch.py", field_npz,
                 str(tmp_path / "texture_torch.npz"), *flags)
    assert sorted(got) == sorted(want) and "features" in got
    assert got["features"].shape[0] >= 32
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_IMPORT_CLI = """
import sys
import patch_matching_and_quilting_torch as cli
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nerf_texture_tpu" or m.startswith("nerf_texture_tpu."))
assert not bad, bad
a = cli.parser().parse_args(["field.npz"])
print(a.output_size, a.mode, a.out)
"""


def test_quilting_cli_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_CLI], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["2048", "Cut", "None"], res.stdout

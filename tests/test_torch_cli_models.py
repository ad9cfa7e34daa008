"""``main_torch.py`` with the SG light model and the vertex encoder:
``--light_model SG`` and ``--encoder vertex --iters_per_level 1``, each
as a subprocess on the CPU at the narrow width of
``tests/test_torch_cli.py`` (whose wrapper this file uses), on a
6-frame 48x48 scene whose template mesh is already in the workspace (the
NGP stage is ``test_torch_cli.py``'s).  Each run trains, prints a
finite PSNR line and writes a checkpoint of its config's field name.
"""

import math

import pytest
import torch

from test_torch_cli import _run
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch import config as tconfig
from nerf_texture_tpu_torch.geometry.mesh import make_icosphere, save_obj
from nerf_texture_tpu_torch.train import trainer as ttr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module (see
    tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [
    ["--light_model", "SG"],
    ["--encoder", "vertex", "--iters_per_level", "1"]])
def test_sg_light_and_vertex_encoder(tmp_path, flags):
    scene, ws = tmp_path / "scene", tmp_path / "ws"
    SyntheticSphereDataset(n_frames=6, H=48, W=48).write_to_disk(str(scene))
    (ws / "meshes").mkdir(parents=True)
    save_obj(str(ws / "meshes" / "surface_coacd_remesh.obj"),
             make_icosphere(3, radius=0.5))
    out = _run("main_torch.py", scene, "--workspace", ws, "--iters", 2,
               "--num_rays", 128, "--eval_interval", 2, "--device", "cpu",
               *flags)
    assert "template:" in out and "[2/2]" in out, out
    psnr = float(out.split("PSNR=")[-1].split()[0])
    assert math.isfinite(psnr) and psnr > 0, out
    kw = dict(zip([f.lstrip("-") for f in flags[::2]], flags[1::2]))
    cfg = tconfig.get_preset(str(scene), light_model=kw.get(
        "light_model", "SH"), encoder_type=kw.get("encoder", "hash"))
    raw = ttr.read_checkpoint(str(ws / "checkpoints" / cfg.field_name))
    assert int(raw["step"]) == 2
    light = raw["params"]["light"]
    if kw.get("encoder") == "vertex":
        assert "feature mesh:" in out, out
        # the preset's single level: the template subdivided to >= 128^2
        assert raw["params"]["field"]["features_v"].shape == (40962, 16)
    else:
        assert light["lgt_sgs"].shape == (8, 5)
        assert set(light) == {"lgt_sgs", "specular_reflectance",
                              "roughness", "albedo_net"}
    assert all(bool(torch.isfinite(t).all())
               for t in ttr.param_leaves(raw["params"]))

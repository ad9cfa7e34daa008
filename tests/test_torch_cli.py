"""The port's training entry points: ``main_nerf_torch.py --save_mesh``,
then ``main_torch.py --distillation`` on its workspace, then a resume,
as subprocesses on the CPU, with the artifacts and printed lines of the
JAX CLIs' smoke test (tests/test_cli_smoke.py); and the port's
``config.py`` against the JAX package's.  ``--light_model`` and
``--encoder vertex`` runs: tests/test_torch_cli_models.py; ``--gui``:
tests/test_torch_viewer.py.  Also ``main_nerf_torch.py --bound 2
--dt_gamma ...`` on a scene of JPEG frames.

The subprocesses run the CLIs' own ``main`` on a 6-frame 48x48 scene
with ``--device cpu``, at a narrow width: a wrapper narrows the NGP, the
feature grid, the normal net's phi grid and the render grid before it
runs the script (at the presets' full width one CPU step takes seconds
and a checkpoint 1.5 GB; the phi grid's fixed 2^16 bricks alone make a
curved checkpoint 0.5 GB, its table, Adam moments and EMA copy).
Every flag, the scene loader, the template pipeline, camera optimisation
(the scene-directory preset's default), distillation and the checkpoints
are the CLIs' own.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from nerf_texture_tpu import config as jconfig
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch import config as tconfig
from nerf_texture_tpu_torch.train import trainer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads a worker for this module: beside
    pytest-xdist's other workers a full thread pool makes every small op
    wait on the busy cores (as in tests/test_torch_projection.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

_NARROW = """
import functools, runpy, sys
sys.path.insert(0, {repo!r})
from nerf_texture_tpu_torch import config
from nerf_texture_tpu_torch.models import ngp, normal_net
from nerf_texture_tpu_torch.ops.hashgrid_packed import PackedGridSpec
from nerf_texture_tpu_torch.render import renderer
ngp.NGPConfig = functools.partial(
    ngp.NGPConfig, num_levels=4, level_dim=2, log2_bricks=10,
    desired_resolution=64, hidden_dim=32, hidden_dim_color=32)
config.MeshFieldConfig = functools.partial(
    config.MeshFieldConfig, level_dim=2, base_resolution=8,
    desired_resolution=32, log2_bricks=10)
normal_net.NormalNetConfig.phi_grid_spec = property(lambda self: PackedGridSpec(
    input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
    desired_resolution=32, log2_bricks=10, align_corners=True))
for_bound = renderer.RenderConfig.for_bound
renderer.RenderConfig.for_bound = staticmethod(lambda b, **kw: for_bound(
    b, **{{**dict(grid_size=32, ray_chunk=1024, max_samples_train=64,
               pool_mean_samples=16, pool_mean_samples_infer=16), **kw}}))
sys.argv = {argv!r}
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _command(script, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2")
    argv = [os.path.join(REPO, script)] + [str(a) for a in args]
    return [sys.executable, "-c", _NARROW.format(repo=REPO, argv=argv)], env


def _run(script, *args, timeout=300):
    cmd, env = _command(script, *args)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, (args, r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


def test_cli_pipeline(tmp_path):
    scene, ws = tmp_path / "scene", tmp_path / "ws"
    SyntheticSphereDataset(n_frames=6, H=48, W=48).write_to_disk(str(scene))
    assert (scene / "transforms.json").exists()

    # stage 1: the coarse NGP and its mesh
    out = _run("main_nerf_torch.py", scene, "--workspace", ws, "--iters",
               150, "--num_rays", 512, "--eval_interval", 75, "--save_mesh",
               "--mesh_resolution", 48, "--device", "cpu")
    assert "PSNR=" in out and "[150/150]" in out, out
    assert (ws / "meshes" / "ngp_mesh.obj").exists(), out[-2000:]
    raw = ttr.read_checkpoint(str(ws / "checkpoints" / "ngp"))
    assert int(raw["step"]) == 150
    assert (ws / "log_ngp.jsonl").exists()

    # stage 2: template pipeline, curved training with the scene preset
    # (camera optimisation on) and distillation from stage 1's NGP
    out = _run("main_torch.py", scene, "--workspace", ws, "--iters", 6,
               "--num_rays", 256, "--eval_interval", 3, "--distillation",
               "--device", "cpu")
    assert "template:" in out and "PSNR=" in out and "[6/6]" in out, out
    assert "teacher on" in out
    assert (ws / "meshes" / "surface_coacd_remesh.obj").exists()
    name = tconfig.get_preset(str(scene)).field_name
    ck = ws / "checkpoints" / name
    raw = ttr.read_checkpoint(str(ck))
    assert int(raw["step"]) == 6
    cam = raw["params"]["camera"]
    assert set(cam) == {"dRs", "dts", "dfs"}
    assert all(bool(torch.isfinite(v).all()) for v in cam.values())
    assert float(torch.abs(cam["dRs"]).max()) > 0     # the deltas trained

    # stage 3: resume from the checkpoint to 9 steps
    out = _run("main_torch.py", scene, "--workspace", ws, "--iters", 9,
               "--num_rays", 256, "--eval_interval", 3, "--distillation",
               "--device", "cpu")
    assert "loading checkpoint" in out and "loaded step 6" in out, out
    assert "[9/9]" in out and "[3/9]" not in out
    assert int(ttr.read_checkpoint(str(ck))["step"]) == 9
    assert (ws / "log_curved.jsonl").read_text().count("\n") == 3


def _jpeg_scene(path, n_frames=6, hw=48):
    """The synthetic sphere as a colmap scene of JPEG frames (PIL, quality
    90, composited on white)."""
    import json

    import numpy as np
    from PIL import Image

    SyntheticSphereDataset(n_frames=n_frames, H=hw, W=hw).write_to_disk(
        str(path))
    with open(path / "transforms.json") as f:
        meta = json.load(f)
    for fr in meta["frames"]:
        png = path / fr["file_path"]
        rgba = np.asarray(Image.open(png)).astype(np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        fr["file_path"] = fr["file_path"][:-4] + ".jpg"
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            path / fr["file_path"], quality=90)
        png.unlink()
    with open(path / "transforms.json", "w") as f:
        json.dump(meta, f)


def test_cli_bound2_on_a_jpeg_scene(tmp_path):
    """``main_nerf_torch.py --bound 2 --dt_gamma 0.0078125 --save_mesh`` on
    a scene of JPEG frames: it trains over two cascades, evaluates and
    exports the mesh over [-2, 2]^3."""
    scene, ws = tmp_path / "scene", tmp_path / "ws"
    _jpeg_scene(scene)
    out = _run("main_nerf_torch.py", scene, "--workspace", ws, "--iters",
               40, "--num_rays", 256, "--eval_interval", 20, "--save_mesh",
               "--mesh_resolution", 32, "--bound", 2, "--dt_gamma",
               0.0078125, "--device", "cpu")
    assert "[40/40]" in out and "(6 frames 48x48)" not in out, out
    assert "(5 frames 48x48)" in out          # colmap train split
    psnr = float(out.split("PSNR=")[-1].split()[0])
    assert 5.0 < psnr < 100.0, out
    raw = ttr.read_checkpoint(str(ws / "checkpoints" / "ngp"))
    assert tuple(raw["occ"]["density"].shape) == (2, 32 ** 3)
    assert int(raw["occ"]["iter_density"]) > 0
    assert (ws / "meshes" / "ngp_mesh.obj").exists()


def test_cli_flags_match_the_jax_clis(monkeypatch):
    """Every flag of the JAX twin, its default, plus --device (cuda)."""
    monkeypatch.syspath_prepend(REPO)
    import main as jmain
    import main_nerf as jmain_nerf
    import main_nerf_torch
    import main_torch

    for ours, theirs, pos in ((main_nerf_torch, jmain_nerf, ["scene"]),
                              (main_torch, jmain, ["scene"])):
        a = vars(ours.parse_args(pos))
        monkeypatch.setattr(sys, "argv", ["x"] + pos)
        b = vars(theirs.parse_args())
        assert a.pop("device") == "cuda"
        assert a == b
    # --gui and --port reach the viewer (test_torch_viewer.py runs it)
    for ours in (main_nerf_torch, main_torch):
        a = ours.parse_args(["scene", "--gui", "--port", "0"])
        assert (a.gui, a.port) == (True, 0)
    # the vertex encoder and the light models are ported (test_cli_pipeline
    # trains both); their flags reach the preset
    args = main_torch.parse_args(["scene", "--encoder", "vertex",
                                  "--iters_per_level", "5", "--light_model",
                                  "Envmap"])
    assert (args.encoder, args.iters_per_level, args.light_model) == (
        "vertex", 5, "Envmap")


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_config_matches_jax():
    ours = [(f.name, f.default) for f in
            dataclasses.fields(tconfig.SceneConfig)]
    theirs = [(f.name, f.default) for f in
              dataclasses.fields(jconfig.SceneConfig)]
    assert ours == theirs
    assert tconfig.PRESETS.keys() == jconfig.PRESETS.keys()
    for name in tconfig.PRESETS:
        assert dataclasses.asdict(tconfig.PRESETS[name]) == \
            dataclasses.asdict(jconfig.PRESETS[name])
    for name, kw in (("durian", {}), ("synthetic_sphere", {"iters": 7}),
                     ("unknown_scene", {"num_rays": 128}),
                     (REPO + "/tests", {"light_model": "None"}),
                     ("star_flower", {"encoder_type": "vertex",
                                      "iters_per_level": 10})):
        a, b = tconfig.get_preset(name, **kw), jconfig.get_preset(name, **kw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for prop in ("ngp", "field", "curved", "render", "train",
                     "curved_train", "field_name"):
            assert _asdict(getattr(a, prop)) == _asdict(getattr(b, prop)), \
                prop
    scene = tconfig.get_preset(REPO + "/tests")
    assert (scene.name, scene.workspace) == ("tests", "./logs/tests")
    assert scene.optimize_camera and scene.curved_train.optimize_camera
    assert scene.render.proxy_samples == 32

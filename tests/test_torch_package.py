"""The PyTorch port as a package: no JAX at run time, configs that convert,
fixtures equal to the JAX package's, and a kernel build that never falls
back."""

import dataclasses
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_texture_tpu.data import synthetic as jax_synthetic
from nerf_texture_tpu.data.poses import orbit_pose as jax_orbit_pose
from nerf_texture_tpu.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu.utils.metrics import psnr as jax_psnr
from nerf_texture_tpu.models.ngp import NGPConfig as JaxNGPConfig
from nerf_texture_tpu.ops.hashgrid_packed import (
    PackedGridSpec as JaxPackedGridSpec)
from nerf_texture_tpu.render.renderer import RenderConfig as JaxRenderConfig
from nerf_texture_tpu.synthesis.patches import (
    PatchSampleConfig as JaxPatchSampleConfig)
from nerf_texture_tpu.synthesis.quilting import (
    QuiltingConfig as JaxQuiltingConfig)
from nerf_texture_tpu.train.trainer import TrainConfig as JaxTrainConfig
from nerf_texture_tpu.models import curved_field as jax_curved_field
from nerf_texture_tpu.models import mesh_field as jax_mesh_field
from nerf_texture_tpu.models import normal_net as jax_normal_net
from nerf_texture_tpu.models.lights import envmap as jax_envmap
from nerf_texture_tpu.models.lights import sg as jax_sg
from nerf_texture_tpu.models.lights import sh as jax_sh
from nerf_texture_tpu.train import curved_trainer as jax_curved_trainer
from nerf_texture_tpu_torch import kernels
from nerf_texture_tpu_torch.data import synthetic
from nerf_texture_tpu_torch.data.poses import orbit_pose
from nerf_texture_tpu_torch.data.rays import sample_ray_indices
from nerf_texture_tpu_torch.data.synthetic import sphere_intrinsics
from nerf_texture_tpu_torch.models.ngp import NGPConfig
from nerf_texture_tpu_torch.ops.hashgrid_packed import PackedGridSpec
from nerf_texture_tpu_torch.ops.proxy_select import (proxy_select,
                                                     proxy_select_cdf)
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.synthesis.patches import PatchSampleConfig
from nerf_texture_tpu_torch.synthesis.quilting import QuiltingConfig
from nerf_texture_tpu_torch.train.trainer import TrainConfig
from nerf_texture_tpu_torch.utils.metrics import psnr
from nerf_texture_tpu_torch.models import curved_field, mesh_field, normal_net
from nerf_texture_tpu_torch.models.lights import envmap, sg, sh
from nerf_texture_tpu_torch.train import curved_trainer

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import nerf_texture_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "nerf_texture_tpu", "cv2", "PIL",
                                    "imageio"))
print(len(names), "modules")
assert not bad, bad
par = {n for n in names if n.startswith("nerf_texture_tpu_torch.parallel.")}
assert par == {"nerf_texture_tpu_torch.parallel." + m for m in
               ("distributed", "eval", "sharding", "train")}, par
# every script of the port beside the package (scripts/torch_*.py, the
# ones that run on the card) too
import glob, os
sys.path.insert(0, "scripts")
scripts = sorted(glob.glob("scripts/torch_*.py"))
for path in scripts:
    importlib.import_module(os.path.basename(path)[:-3])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "nerf_texture_tpu"))
assert not bad, bad
print(len(scripts), "scripts")
"""


def test_port_imports_no_jax():
    """Every module of the port imports, and pulls in neither JAX, the JAX
    package, nor an image library (OpenCV, PIL, imageio); every
    ``scripts/torch_*.py`` imports without JAX or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 43, res.stdout
    # the shell pipeline, its replay, the frame A/B, the card-vs-CPU
    # training, the bench cells and the CLI spread among them
    assert int(res.stdout.split()[2]) >= 10, res.stdout


_IMPORT_SURFACES = """
import sys
import nerf_texture_tpu_torch.geometry.shape_tools
import nerf_texture_tpu_torch.synthesis.curved
import nerf_texture_tpu_torch.ops.isosurface
import texture_synthesis_on_curved_surface_torch as cli
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nerf_texture_tpu" or m.startswith("nerf_texture_tpu."))
assert not bad, bad
print(cli.parser().parse_args(["field.npz", "mesh.obj"]).device)
"""


def test_surface_modules_and_cli_import_no_jax():
    """The curved synthesis, the shape tools, the isosurface and the
    curved-synthesis CLI import no JAX; the CLI's queries default to the
    card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_SURFACES], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "cuda", res.stdout


_IMPORT_CLIS = """
import sys
import main_nerf_torch, main_torch
import nerf_texture_tpu_torch.config
import nerf_texture_tpu_torch.data.provider
import nerf_texture_tpu_torch.data.images
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "nerf_texture_tpu" or m.startswith("nerf_texture_tpu."))
assert not bad, bad
print(main_nerf_torch.parse_args(["s"]).device,
      main_torch.parse_args(["s"]).device)
"""


def test_training_clis_import_no_jax_and_need_the_card(tmp_path):
    """The two training CLIs and the new modules import no JAX; --device
    defaults to the card, and on a host without one a run raises before
    it trains or writes a checkpoint (nothing falls back to the CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_CLIS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["cuda", "cuda"], res.stdout
    if torch.cuda.is_available():
        return
    synthetic.SyntheticSphereDataset(n_frames=3, H=16, W=16).write_to_disk(
        str(tmp_path / "scene"))
    for cli in ("main_nerf_torch.py", "main_torch.py"):
        ws = tmp_path / f"ws_{cli}"
        res = subprocess.run(
            [sys.executable, str(REPO / cli), str(tmp_path / "scene"),
             "--workspace", str(ws), "--iters", "2"], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert res.returncode != 0, (cli, res.stdout)
        assert "CUDA" in res.stderr or "cuda" in res.stderr, res.stderr
        assert not (ws / "checkpoints").exists()


_IMPORT_VIEWER = """
import sys
import numpy as np
import chip_smoke, main_nerf_torch, main_torch
from nerf_texture_tpu_torch.data import images, jpeg, prepare, provider
from nerf_texture_tpu_torch.viewer import ViewerApp, serve
img = np.arange(16 * 24 * 3, dtype=np.uint8).reshape(16, 24, 3)
assert jpeg.decode(jpeg.encode(img, quality=90)).shape == (16, 24, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "nerf_texture_tpu", "PIL",
                                    "imageio", "cv2"))
assert not bad, bad
print(main_nerf_torch.parse_args(["s", "--gui"]).port)
"""


def test_viewer_codec_and_smoke_import_no_jax_or_image_library():
    """The viewer, the JPEG codec, the scene loader, both CLIs and the
    smoke script import neither JAX nor an image library (PIL, imageio,
    OpenCV), and the codec round-trips without one."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_VIEWER], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "7860", res.stdout


_CAPTURE_BLOCKED = """
import importlib.abc, json, os, sys
BLOCKED = ("jax", "jaxlib", "nerf_texture_tpu", "PIL", "imageio", "cv2")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")


sys.meta_path.insert(0, Block())
import numpy as np
from nerf_texture_tpu_torch.data import images, jpeg, prepare, provider
fx = os.path.join("tests", "fixtures", "formats")
with open(os.path.join(fx, "manifest.json")) as f:
    manifest = json.load(f)
n = 0
for name, entry in sorted(manifest.items()):
    img = images.read_image(os.path.join(fx, name))
    want = entry["imread"]
    if "npy" in want:
        ref = np.load(os.path.join(fx, want["npy"]))
        assert np.array_equal(img, ref), name
    if img.dtype != bool and (img.ndim == 2 or img.shape[-1] != 2):
        assert prepare.laplacian_variance(img) >= 0.0, name
    n += 1
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(n, prepare.prepare_scene.__module__)
"""


def test_capture_path_runs_without_jax_or_image_libraries():
    """The capture-to-scene modules (``data.prepare``, ``data.images``,
    ``data.jpeg``, ``data.provider``) import and decode every committed
    format fixture with jax, the JAX package, PIL, imageio and OpenCV
    blocked, as on the card's machine, which has none of them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _CAPTURE_BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    n, mod = res.stdout.split()
    assert int(n) >= 27 and mod == "nerf_texture_tpu_torch.data.prepare"


@pytest.mark.parametrize("ours,theirs", [
    (RenderConfig, JaxRenderConfig), (NGPConfig, JaxNGPConfig),
    (PackedGridSpec, JaxPackedGridSpec), (TrainConfig, JaxTrainConfig),
    (PatchSampleConfig, JaxPatchSampleConfig),
    (QuiltingConfig, JaxQuiltingConfig)])
def test_config_fields_match_jax(ours, theirs):
    mine = [(f.name, f.default) for f in dataclasses.fields(ours)]
    ref = [(f.name, f.default) for f in dataclasses.fields(theirs)]
    assert mine == ref


def _fields(cls):
    """(name, default) of a config dataclass; nested config defaults as
    their own field lists."""
    out = []
    for f in dataclasses.fields(cls):
        d = f.default
        out.append((f.name, _fields(type(d)) if dataclasses.is_dataclass(d)
                    else d))
    return out


@pytest.mark.parametrize("ours,theirs", [
    (curved_field.CurvedFieldConfig, jax_curved_field.CurvedFieldConfig),
    (mesh_field.MeshFieldConfig, jax_mesh_field.MeshFieldConfig),
    (curved_trainer.CurvedTrainConfig,
     jax_curved_trainer.CurvedTrainConfig),
    (sh.SHLightConfig, jax_sh.SHLightConfig),
    (sg.SGLightConfig, jax_sg.SGLightConfig),
    (envmap.EnvmapLightConfig, jax_envmap.EnvmapLightConfig),
    (normal_net.NormalNetConfig, jax_normal_net.NormalNetConfig)])
def test_curved_config_fields_match_jax(ours, theirs):
    assert _fields(ours) == _fields(theirs)


def test_curved_bench_configs_convert():
    """bench.py's curved arm: the field config converts field by field
    and gives the same table layouts and embedding widths."""
    j = jax_curved_field.CurvedFieldConfig(
        field=jax_mesh_field.MeshFieldConfig(), light_model="SH")
    t = curved_field.CurvedFieldConfig(
        field=mesh_field.MeshFieldConfig(**dataclasses.asdict(j.field)),
        **{k: v for k, v in dataclasses.asdict(j).items() if k != "field"})
    for a, b in ((t.field.feature_spec, j.field.feature_spec),
                 (t.field.normal_cfg.phi_grid_spec,
                  j.field.normal_cfg.phi_grid_spec)):
        assert (a.offsets, a.table_rows, a.storage_width, a.row_width,
                a.dual_storage_width) == (b.offsets, b.table_rows,
                                          b.storage_width, b.row_width,
                                          b.dual_storage_width)
    assert t.field.feature_spec.table_rows == 524288
    assert t.field.feature_spec.dual_storage_width == 128
    assert (t.field.embed_dim, t.sh_cfg, t.field_name) == (
        j.field.embed_dim, sh.SHLightConfig(**dataclasses.asdict(j.sh_cfg)),
        j.field_name)
    assert dataclasses.asdict(t.field.normal_cfg) == \
        dataclasses.asdict(j.field.normal_cfg)
    # the other light models' and the vertex encoder's derived configs
    assert dataclasses.asdict(t.sg_cfg) == dataclasses.asdict(j.sg_cfg)
    assert dataclasses.asdict(t.env_cfg) == dataclasses.asdict(j.env_cfg)
    v = dict(encoder_type="vertex", n_feature_vertices=642)
    jv = jax_mesh_field.MeshFieldConfig(**v)
    tv = mesh_field.MeshFieldConfig(**v)
    assert (tv.encoder_f_out_dim, tv.embed_dim) == (jv.encoder_f_out_dim,
                                                    jv.embed_dim)
    assert mesh_field.levels_vnum(tv) == jax_mesh_field.levels_vnum(jv)


def test_bench_configs_convert():
    kw = dict(bound=1.0, num_levels=8, level_dim=4, log2_bricks=16,
              desired_resolution=2048)
    a, b = NGPConfig(**kw).packed_spec, JaxNGPConfig(**kw).packed_spec
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.offsets, a.table_rows, a.storage_width, a.row_width) == (
        b.offsets, b.table_rows, b.storage_width, b.row_width)
    r = JaxRenderConfig(grid_size=128, ray_chunk=16384, proxy_samples=0,
                        infer_color_cap=4, prepass_block=8,
                        prepass_tau_cull=0.1)
    assert dataclasses.asdict(RenderConfig(**dataclasses.asdict(r))) == \
        dataclasses.asdict(r)


def test_fixtures_match_jax_package():
    for theta, phi in [(1.2, 0.7), (np.pi / 2, 0.0), (2.5, 4.0)]:
        np.testing.assert_array_equal(orbit_pose(theta, phi, 2.0),
                                      jax_orbit_pose(theta, phi, 2.0))
    ds = SyntheticSphereDataset(n_frames=2, H=48, W=40)
    np.testing.assert_array_equal(sphere_intrinsics(48, 40), ds.intrinsics)


def test_synthetic_dataset_mirrors_jax_package():
    ours = synthetic.SyntheticSphereDataset(n_frames=3, H=24, W=20, seed=4)
    theirs = SyntheticSphereDataset(n_frames=3, H=24, W=20, seed=4)
    assert ours.num_frames == theirs.num_frames == 3
    assert (ours.H, ours.W, ours.radius, ours.sphere_radius) == \
        (theirs.H, theirs.W, theirs.radius, theirs.sphere_radius)
    for name in ("poses", "images", "intrinsics"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert 0 < (ours.images[..., 3] > 0).mean() < 1
    pts = np.random.default_rng(0).normal(size=(50, 3))
    np.testing.assert_array_equal(synthetic.sphere_texture(pts),
                                  jax_synthetic.sphere_texture(pts))


def test_ray_sampling_and_psnr():
    inds, coarse = sample_ray_indices(torch.Generator().manual_seed(0), 8,
                                      10, 4000)
    assert coarse is None and inds.dtype == torch.int64
    assert int(inds.min()) == 0 and int(inds.max()) == 79
    assert len(torch.unique(inds)) == 80
    # with an error map: n distinct cells of the 128 x 128 map, a pixel
    # in each (tests/test_torch_training_features.py holds it to JAX)
    inds, coarse = sample_ray_indices(torch.Generator().manual_seed(0), 8,
                                      10, 40, error_map=torch.ones(128 * 128))
    assert len(torch.unique(coarse)) == 40
    assert int(inds.min()) >= 0 and int(inds.max()) <= 79
    with pytest.raises(ValueError, match="error map"):
        sample_ray_indices(torch.Generator(), 8, 10, 4,
                           error_map=torch.ones(16))
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(2, 6, 5, 3)).astype(np.float32)
    assert psnr(torch.from_numpy(a), b) == jax_psnr(a, b)
    assert psnr(a, a) == jax_psnr(a, a) == 99.0


def _device_params():
    """(where, default) of every parameter named ``device`` of the
    package's public functions, classes and their methods."""
    import nerf_texture_tpu_torch as pkg

    found = []
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                fns = [(f"{name}.{m}", f) for m, f in vars(obj).items()
                       if (m == "__init__" or not m.startswith("_"))]
                fns = [(n, f.__func__ if isinstance(f, (staticmethod,
                                                        classmethod)) else f)
                       for n, f in fns]
            for qual, fn in fns:
                if not inspect.isfunction(fn):
                    continue
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    found.append((f"{mod.__name__}.{qual}", param.default))
    return found


def test_no_device_defaults_to_the_cpu():
    """The port's entry points run on the card unless the caller asks for
    the CPU: no ``device`` parameter defaults to the CPU (or to None,
    torch's CPU default)."""
    found = _device_params()
    where = {w for w, _ in found}
    for entry in ("nerf_texture_tpu_torch.train.trainer.Trainer.__init__",
                  "nerf_texture_tpu_torch.train.curved_trainer."
                  "CurvedTrainer.__init__",
                  "nerf_texture_tpu_torch.geometry.projector."
                  "MeshProjector.__init__",
                  "nerf_texture_tpu_torch.convert.params_from_jax",
                  "nerf_texture_tpu_torch.convert.occupancy_from_jax",
                  "nerf_texture_tpu_torch.geometry.projector."
                  "pointcloud_arrays",
                  "nerf_texture_tpu_torch.models.mesh_field."
                  "import_field_data",
                  "nerf_texture_tpu_torch.models.mesh_field."
                  "import_patch_data",
                  "nerf_texture_tpu_torch.models.mesh_field."
                  "import_unhash_data",
                  "nerf_texture_tpu_torch.geometry.shape_tools."
                  "register_template",
                  "nerf_texture_tpu_torch.synthesis.curved.resize_bilinear",
                  "nerf_texture_tpu_torch.synthesis.curved.MatchingLib."
                  "__init__",
                  "nerf_texture_tpu_torch.ops.isosurface."
                  "sample_density_grid",
                  "nerf_texture_tpu_torch.ops.isosurface.extract_mesh",
                  "nerf_texture_tpu_torch.train.field_io.save_mesh"):
        assert entry in where, entry
    cpu = [(w, d) for w, d in found if d is None
           or (d is not inspect.Parameter.empty
               and torch.device(d).type == "cpu")]
    assert not cpu, cpu


def test_no_kernel_no_fallback_on_other_devices():
    sig = torch.ones((4, 8), device="meta")
    t = torch.zeros(4, device="meta")
    for select in (proxy_select_cdf, proxy_select):
        with pytest.raises(ValueError, match="no kernel"):
            select(sig, sig, t, t, cap=2, w_eps=1e-4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("proxy_select")
    assert not (tmp_path / "kernels").exists() or \
        not any((tmp_path / "kernels").iterdir())


def _fake_nvcc(tmp_path, rc=0):
    """A stand-in nvcc that writes its -o target (or fails)."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
                    "done\n"
                    f"[ {rc} -eq 0 ] || {{ echo boom >&2; exit {rc}; }}\n"
                    "echo built > \"$out\"\n")
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


def test_build_is_keyed_by_source_and_atomic(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path)))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "out")
    first = kernels.build("k")
    assert first.path.read_text() == "built\n"
    again = kernels.build("k")
    assert again.path == first.path and again.seconds == 0.0
    (csrc / "k.cu").write_text("// v2\n")
    changed = kernels.build("k")
    assert changed.path != first.path
    # only the two finished libraries: no temporary file is left behind
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        [first.path.name, changed.path.name])


def test_failed_build_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, rc=2)))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// broken\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="boom"):
        kernels.build("k")
    assert not any((tmp_path / "out").iterdir())

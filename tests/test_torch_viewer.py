"""The port's viewer (``nerf_texture_tpu_torch.viewer``) vs the JAX
package's: the orbit camera and the frame-time controllers, the public
actions of ``ViewerApp``, its frames at two resolution tiers on a tiny
curved trainer holding JAX's params and grid (the fixture of
tests/test_torch_curved_render.py), the HTTP server's endpoints, and
``--gui`` of both training CLIs as subprocesses on the CPU (through the
narrow wrapper of tests/test_torch_cli.py).

Tolerances, each with its reason:
- intrinsics, the poses of construction, zoom and pan, and the
  controllers' sequences exactly (the same numpy and Python arithmetic);
- orbit poses within 1e-6: the rotation's sin and cos are numpy's in the
  port and XLA's in the JAX package, and the two differ in the last bit
  for ~3% of f32 arguments (measured over 2e5 values), so a rotation
  entry may differ by an ulp (measured: 105 of 2000 random rotations
  differ, by at most 1.2e-7);
- frames: the curved frame bounds of tests/test_torch_curved_render.py
  (PSNR >= 45 dB, max abs <= 5e-2), on the uint8 images both apps
  return.
"""

import json
import subprocess
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from nerf_texture_tpu.viewer import app as japp_mod
from nerf_texture_tpu.viewer import camera as jcam
from nerf_texture_tpu.viewer import controllers as jctl
from nerf_texture_tpu.viewer import server as jserver
from nerf_texture_tpu_torch.data import jpeg
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.viewer import ViewerApp, serve
from nerf_texture_tpu_torch.viewer import camera as tcam
from nerf_texture_tpu_torch.viewer import controllers as tctl
from test_torch_cli import REPO, _command
from test_torch_curved_render import HW, trainers  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_orbit_camera_matches_jax():
    a, b = jcam.OrbitCamera(64, 48, radius=2.5), tcam.OrbitCamera(
        64, 48, radius=2.5)
    np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
    for cam in (a, b):
        cam.scale(1)
        cam.scale(-0.5)
        cam.pan(30, -12, 4)
        cam.fovy = 40.0
    np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
    rng = np.random.default_rng(0)
    for dx, dy in rng.normal(0, 40, (12, 2)):
        a.orbit(dx, dy)
        b.orbit(dx, dy)
        np.testing.assert_allclose(b.pose, a.pose, rtol=0, atol=1e-6)
    # still a rotation at the orbit's radius
    np.testing.assert_allclose(b.rot @ b.rot.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b.pose[:3, 3] - b.center),
                               b.radius, rtol=1e-5)


def test_controllers_match_jax():
    rng = np.random.default_rng(1)
    times = list(rng.uniform(5, 2500, 40)) + [0.0, 1e9, 1.0]
    a, b = jctl.TrainStepController(), tctl.TrainStepController()
    assert [a.update(t) for t in times] == [b.update(t) for t in times]
    a = jctl.ResolutionController(target_ms=150)
    b = tctl.ResolutionController(target_ms=150)
    seq_a, seq_b = [], []
    for i, t in enumerate(times):
        if i == 20:
            a.enabled = b.enabled = False
        seq_a.append(a.update(t))
        seq_b.append(b.update(t))
    assert seq_a == seq_b and len(set(seq_a)) > 1
    with tctl.FrameTimer() as t:
        time.sleep(0.01)
    assert t.ms >= 10.0


def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_")
                  and callable(getattr(cls, n)))


def test_viewer_app_has_the_jax_methods():
    assert _public(ViewerApp) == _public(japp_mod.ViewerApp)


def test_frames_at_two_tiers_match_jax(trainers):  # noqa: F811
    tj, tt = trainers
    aj = japp_mod.ViewerApp(tj, W=HW, H=HW)
    at = ViewerApp(tt, W=HW, H=HW)
    aj.camera.orbit(35, -20)
    at.camera.rot = aj.camera.rot.copy()
    np.testing.assert_array_equal(aj.camera.pose, at.camera.pose)
    for tier in (0, 3):                      # downscale 4, then 1
        for app in (aj, at):
            app.set_dynamic_resolution(False, tier=tier)
        want, got = aj.render(), at.render()
        assert got.dtype == np.uint8 and got.shape == want.shape == (
            HW, HW, 3)
        err = np.abs(got.astype(np.float64) - want) / 255.0
        assert err.max() <= 5e-2
        assert -10 * np.log10(np.mean(err ** 2) + 1e-20) >= 45.0
        if tier == 3:
            # the full frame has structure (the downscaled tier renders
            # with the dataset's intrinsics unscaled, as the JAX viewer
            # does, and its repeated corner may be all background)
            assert want.std() > 3
            assert at.last_frame["chunks"] >= 1


def test_actions_on_the_trainer(trainers, tmp_path):  # noqa: F811
    _, tt = trainers
    app = ViewerApp(tt, W=HW, H=HW)
    app.set_dynamic_resolution(False, tier=3)
    full = app.render()
    assert app.switch_visual_mode() == "UV" and tt.visual_mode == "UV"
    app.switch_visual_mode("RGB")
    assert app.switch_light_mode() == "Specular"
    app.switch_light_mode("Full")
    # the crop that halves x renders fewer live rays; an empty one none
    app.set_aabb(0, 0.0)
    assert list(tt.crop_aabb) == [0, -1, -1, 1, 1, 1]
    half = app.render()
    live_half = app.last_frame["live"]
    app.set_aabb(3, -0.5)                    # xmax < xmin: empty
    assert (app.render() == 255).all() and app.last_frame["live"] == 0
    tt.crop_aabb = None
    app.render()
    assert 0 < live_half < app.last_frame["live"]
    assert not np.array_equal(half, full)
    app.set_sdf_factor(1.5)
    app.set_sdf_offset(0.01)
    app.set_uv_rate(0.9)
    app.set_fc_weight(0.5)
    assert tt.runtime == (1.5, 0.01, 0.9, 0.5)
    tt.runtime = tt.runtime._replace(sdf_scale_factor=1.0, sdf_offset=0.0,
                                     uv_utilize_rate=1.0, fc_weight=1.0)
    app.set_euler(0.1, 0.0, 0.2)
    assert tt.euler.dtype == np.float32
    tt.euler = None
    app.set_dt_gamma(1 / 128)
    assert tt.rcfg.dt_gamma == 1 / 128
    out = tt.render_frame(app.camera.pose, H=HW, W=HW, parity=True)
    assert out["chunks"] >= 1 and bool(torch.isfinite(out["image"]).all())
    app.set_dt_gamma(0.0)
    app.set_bg(0.0)
    app.set_fovy(40.0)
    assert app.camera.fovy == 40.0
    app.reset_camera()
    app.set_bg(1.0)
    photo = tmp_path / "photo.png"
    img = app.take_photo(str(photo), H=24, W=24)
    assert photo.exists() and img.shape == (24, 24, 3)
    assert app.toggle_baked() is True and app.toggle_baked() is False
    # the light exported as an equirect image
    env = tmp_path / "env.png"
    app.save_envmap(str(env), H=8)
    from nerf_texture_tpu_torch.data.images import read_png
    assert read_png(str(env)).shape == (8, 16, 3)
    # pick_region needs a template mesh; then save_field keeps to it
    assert app.pick_region(0, 0, HW, HW) == 0
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    tt.template_mesh = make_icosphere(2, radius=0.5)
    n = app.pick_region(0, 0, HW, HW)
    assert 0 < n < len(tt.template_mesh.faces)
    assert tt.picked_faces.size == n
    app.clear_picked_region()
    tt.template_mesh = None


def test_frame_loop_trains():
    """``frame`` with training on runs the controller's steps, keeps the
    step in the metrics and renders."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field
    from nerf_texture_tpu_torch.train import curved_trainer as tct
    from test_torch_curved_render import _configs

    _, ct, _, rt = _configs()
    tt = tct.CurvedTrainer(
        SyntheticSphereDataset(n_frames=2, H=24, W=24),
        mesh_field.make_state(MeshProjector(make_icosphere(2, radius=0.5),
                                            device="cpu")), ct, rt,
        tct.CurvedTrainConfig(num_rays=64), device="cpu")
    app = ViewerApp(tt, W=24, H=24)
    app.train_ctrl.steps = 2
    app.training = True
    img = app.frame()
    assert img.shape == (24, 24, 3) and img.dtype == np.uint8
    assert app.last_metrics["step"] == 2 == tt.state.step
    assert np.isfinite(app.last_metrics["loss"])
    assert "losses" not in app.last_metrics and app.frames == 1
    assert 1 <= app.train_ctrl.steps <= 16


class _Stub:
    """An app whose frames are constant, to read the JAX server's
    /status without rendering through JAX."""

    training = False
    last_metrics = {}

    def __init__(self):
        self.train_ctrl = jctl.TrainStepController()
        self.res_ctrl = jctl.ResolutionController()
        self.trainer = object()
        self.camera = jcam.OrbitCamera(32, 32)

    def frame(self):
        time.sleep(0.02)
        return np.zeros((32, 32, 3), np.uint8)


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=30).read()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/control",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    return urllib.request.urlopen(req, timeout=60).status


def _read_part(stream) -> np.ndarray:
    """The next MJPEG part of a /stream response, decoded."""
    head = b""
    while b"\r\n\r\n" not in head:
        head += stream.read(1)
    assert b"--frame" in head and b"image/jpeg" in head
    n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
    return jpeg.decode(stream.read(n))


def _serve(server_fn, app):
    httpd, stop = server_fn(app, host="127.0.0.1", port=0, block=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, stop, httpd.server_address[1]


def test_http_server_matches_jax_endpoints(trainers, tmp_path):  # noqa: F811
    _, tt = trainers
    httpd_j, stop_j, port_j = _serve(jserver.serve, _Stub())
    try:
        status_j = json.loads(_get(port_j, "/status"))
    finally:
        stop_j.set()
        httpd_j.shutdown()
    app = ViewerApp(tt, W=HW, H=HW)
    app.set_dynamic_resolution(False, tier=3)
    httpd, stop, port = _serve(serve, app)
    try:
        status = json.loads(_get(port, "/status"))
        assert sorted(status) == sorted(status_j)
        assert status["downscale"] == 1 and status["training"] is False
        assert _post(port, {"action": "orbit", "dx": 5, "dy": 3}) == 200
        assert _post(port, {"action": "set_bg", "v": 0.5}) == 200
        assert app.bg_color == 0.5
        assert b"viewer" in _get(port, "/")
        # MJPEG parts: each decodes; the first may be the 64x64 black
        # frame the server holds before the loop's first frame
        stream = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                        timeout=60)
        shapes = []
        for _ in range(2):
            img = _read_part(stream)
            shapes.append(img.shape)
            if img.shape == (HW, HW, 3):
                break
        stream.close()
        assert shapes[-1] == (HW, HW, 3), shapes
        assert img.dtype == np.uint8 and img.std() > 3
        from nerf_texture_tpu_torch.utils.misc import MetricsLogger
        tt.logger = MetricsLogger(str(tmp_path), "curved")
        tt.logger.log(1, loss=0.5, psnr=20.0)
        tt.logger.log(2, loss=0.4, psnr=21.5)
        scalars = json.loads(_get(port, "/scalars"))
        assert scalars["loss"] == [[1, 0.5], [2, 0.4]]
        assert b"scalars" in _get(port, "/dashboard")
        # an action that fails answers 500 and the server goes on
        try:
            _post(port, {"action": "set_fovy"})
            raise AssertionError("a failing action answered 200")
        except urllib.error.HTTPError as e:
            assert e.code == 500
        assert json.loads(_get(port, "/status"))["training"] is False
    finally:
        stop.set()
        httpd.shutdown()
        tt.logger = None


@pytest.mark.parametrize("script", ["main_nerf_torch.py", "main_torch.py"])
def test_gui_serves(tmp_path, script):
    """``--gui --port 0``: the CLI loads its state, serves the viewer
    (training), answers /status and a /stream part, takes a /control
    action and ends with exit code 0 on SIGTERM."""
    import json
    import signal
    import urllib.request

    from nerf_texture_tpu_torch.data.jpeg import decode
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere, save_obj

    scene, ws = tmp_path / "scene", tmp_path / "ws"
    SyntheticSphereDataset(n_frames=4, H=32, W=32).write_to_disk(str(scene))
    if script == "main_torch.py":
        (ws / "meshes").mkdir(parents=True)
        save_obj(str(ws / "meshes" / "surface_coacd_remesh.obj"),
                 make_icosphere(2, radius=0.5))
    cmd, env = _command(script, scene, "--workspace", ws, "--num_rays", 128,
                        "--gui", "--port", 0, "--device", "cpu")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while True:
            line = proc.stdout.readline()
            assert line, "".join(lines)[-3000:]
            lines.append(line)
            if line.startswith("[viewer] serving on"):
                port = int(line.rsplit(":", 1)[1])
                break
        url = f"http://127.0.0.1:{port}"
        status = json.loads(urllib.request.urlopen(url + "/status",
                                                   timeout=120).read())
        assert status["training"] is True
        stream = urllib.request.urlopen(url + "/stream", timeout=300)
        head = b""
        while b"\r\n\r\n" not in head:
            head += stream.read(1)
        n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
        assert decode(stream.read(n)).dtype.name == "uint8"
        stream.close()
        req = urllib.request.Request(
            url + "/control", data=json.dumps(
                {"action": "stop_training"}).encode(), method="POST")
        assert urllib.request.urlopen(req, timeout=300).status == 200
        assert json.loads(urllib.request.urlopen(
            url + "/status", timeout=120).read())["training"] is False
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stdout.read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

"""The port's scribble UI (``viewer/segment.py``) against the JAX package's:
the JAX test's HTTP flow against the port's server (a session on the
CPU), every op and error reply, and ``/frame`` byte for byte the JPEG that
the JAX package's ``_frame_jpeg`` (PIL) writes for the same frame, mask
and strokes."""

import json
import os
import socket
import threading
import urllib.request

import imageio.v3 as iio
import numpy as np
import pytest

from nerf_texture_tpu.data.segmenter import MaskSession as JaxSession
from nerf_texture_tpu.viewer import segment as jseg
from nerf_texture_tpu_torch.data.segmenter import MaskSession
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.viewer import segment as pseg


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    ds = SyntheticSphereDataset(n_frames=4, H=96, W=96)
    root = tmp_path_factory.mktemp("uiscene")
    frames = root / "frames"
    frames.mkdir()
    gts = []
    for i, img in enumerate(ds.images):
        rgb = img[..., :3].astype(np.float32)
        a = img[..., 3:].astype(np.float32) / 255.0
        iio.imwrite(frames / f"{i:04d}.png",
                    (rgb * a + 24.0 * (1 - a)).astype(np.uint8))
        gts.append(a[..., 0] > 0.5)
    return str(frames), gts


def _iou(a, b):
    return (a & b).sum() / max(1, (a | b).sum())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_segment_http_ui(scene):
    """The JAX test's flow, then the other ops, against the port."""
    frames, gts = scene
    s = MaskSession(frames, device="cpu")
    port = _free_port()
    httpd = pseg.serve_segmenter(s, host="127.0.0.1", port=port,
                                 block=False)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{port}"

    def api(body):
        req = urllib.request.Request(url + "/api",
                                     data=json.dumps(body).encode(),
                                     method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    try:
        page = urllib.request.urlopen(url + "/", timeout=10).read()
        assert page == jseg._PAGE.encode()
        ys, xs = np.nonzero(gts[0])
        cy, cx = int(ys.mean()), int(xs.mean())
        assert api({"op": "info"}) == {"ok": True, "n": 4}
        api({"op": "stroke", "i": 0, "label": 1,
             "points": [[cx - 10, cy], [cx + 10, cy]]})
        api({"op": "stroke", "i": 0, "label": 2,
             "points": [[2, 2], [93, 2]]})
        assert api({"op": "segment", "i": 0})["ok"]
        assert _iou(s.masks[0], gts[0]) > 0.5
        jpg = urllib.request.urlopen(url + "/frame?i=0", timeout=10).read()
        assert jpg[:2] == b"\xff\xd8"
        # the same bytes as the JAX package's frame of that state
        js = JaxSession(frames)
        js.masks[0] = s.masks[0].copy()
        js.strokes[0][:] = s.strokes[0]
        assert jpg == jseg._frame_jpeg(js, 0)
        assert api({"op": "propagate", "i": 0}) == {"ok": True,
                                                    "masked": 3}
        assert all(_iou(s.masks[i], gts[i]) > 0.5 for i in range(1, 4))
        assert api({"op": "clear", "i": 0})["ok"]
        assert not s.strokes[0].any()
        root = os.path.dirname(frames)
        assert api({"op": "save"}) == {"ok": True, "saved": 4}
        assert sorted(os.listdir(os.path.join(root, "masks"))) == \
            sorted(os.listdir(os.path.join(root, "images_masked")))
        assert api({"op": "nope"}) == {"ok": False,
                                       "error": "unknown op nope"}
        # a failing op replies with its error and the server keeps serving
        err = api({"op": "stroke", "i": 0})
        assert err["ok"] is False and "points" in err["error"]
        assert api({"op": "info"})["n"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("state", ["plain", "masked", "strokes"])
def test_frame_jpeg_matches_jax_bytes(scene, state):
    """/frame's JPEG is byte for byte PIL's (quality 88) of the same
    tinted frame; indices are clamped as in the JAX package."""
    frames, gts = scene
    s = MaskSession(frames, device="cpu")
    js = JaxSession(frames)
    for i in range(4):
        if state != "plain":
            s.masks[i] = gts[i]
            js.masks[i] = gts[i]
        if state == "strokes":
            js.add_stroke(i, [[10, 10 + 5 * i], [60, 40]], 1 + i % 2, 4)
            s.strokes[i][:] = js.strokes[i]
    for idx in (-3, 0, 2, 9):
        assert pseg._frame_jpeg(s, idx) == jseg._frame_jpeg(js, idx)

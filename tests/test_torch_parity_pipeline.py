"""The port's seven-stage pipeline on the textured shell
(``scripts/torch_shell_pipeline.py``: coarse NGP -> mesh -> template +
h_threshold -> curved training -> patch export -> quilting -> re-import
and render) at the FAST profile on the CPU, held to the gates of the JAX
package's ``tests/test_parity_pipeline.py`` FAST tier: NGP > 15 dB at
the held-out pose, > 200 vertices, the median radius within 0.1 of the
base, h < 0.35, curved > 10 dB, >= 4 patches carrying signal, a textured
re-imported canvas and a finite ``load_patch`` frame.  Slow, as the JAX
test is (~100 s on four threads).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_shell_pipeline as pipe  # noqa: E402


@pytest.mark.slow
def test_shell_pipeline_fast_on_the_cpu(tmp_path):
    res = pipe.run("FAST", 0, "cpu", workdir=str(tmp_path))
    assert res["failed"] == [], res
    assert res["ngp_psnr"] > pipe.FAST["ngp_gate"]
    assert res["curved_psnr"] > pipe.FAST["curved_gate"]
    assert res["vertices"] > 200 and res["patches"] >= 4
    assert res["h"] < 0.35
    assert "kernel_frames" not in res        # card only
    print(f"[parity] ngp={res['ngp_psnr']:.2f} dB "
          f"curved={res['curved_psnr']:.2f} dB h={res['h']:.3f}")

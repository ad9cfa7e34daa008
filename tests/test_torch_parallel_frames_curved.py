"""A curved field's band-sharded frame in the port (``parallel.eval.
render_image_sharded`` over 4 data ranks, processes of
``tests/torch_ranks.py``) vs the port's single-rank ``render_image`` of
the same state (no JAX: the port's curved frames are held to JAX's by
``tests/test_torch_curved_render.py``).

The curved frame (``tests/test_parallel.py::
test_curved_sharded_band_render_matches_single``'s config, a field
trained 16 steps on each rank alike): the band path with the anchor table
at ``prepass_block`` 1 and 4 without the tau carve, and at 4 with it,
within 2e-4 of the single-rank frame (that test's bound).
"""

import numpy as np
import pytest

import torch_ranks as R
from nerf_texture_tpu_torch.data.synthetic import SyntheticSphereDataset
from nerf_texture_tpu_torch.models import curved_field as tcf
from nerf_texture_tpu_torch.models import mesh_field as tmf
from nerf_texture_tpu_torch.render.renderer import RenderConfig
from nerf_texture_tpu_torch.train import curved_trainer as tct

CURVED_FIELD = dict(num_levels=3, level_dim=2, base_resolution=16,
                    desired_resolution=32, log2_bricks=9, h_threshold=0.15,
                    clustering=False)
CURVED_RENDER = dict(bound=1.0, cascades=1, grid_size=16, max_steps=32,
                     max_samples_train=24, max_samples_infer=16,
                     ray_chunk=512, pool_mean_samples=16,
                     pool_mean_samples_infer=8, proxy_samples=0,
                     proxy_refined=8, infer_color_cap=4,
                     prepass_tau_cull=0.0)



@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload = {
        "dataset": SyntheticSphereDataset(n_frames=2, H=48, W=48),
        "ccfg": tcf.CurvedFieldConfig(field=tmf.MeshFieldConfig(
            **CURVED_FIELD), light_model="SH", hidden_dim=16,
            geo_feat_dim=7),
        "rcfgs": [RenderConfig(**CURVED_RENDER, prepass_block=1),
                  RenderConfig(**CURVED_RENDER, prepass_block=4),
                  RenderConfig(**dict(CURVED_RENDER, prepass_tau_cull=0.1),
                               prepass_block=4)],
        "tcfg": tct.CurvedTrainConfig(lr=5e-3, total_steps=60, num_rays=128,
                                      grid_update_interval=8,
                                      grid_full_updates=2),
        "steps": 16}
    return {"curved": R.run_ranks(R.curved_frames_job, 4, payload,
                                  tmp_path_factory.mktemp("ranks"))}


@pytest.mark.parametrize("block", [0, 1, 2])
def test_curved_band_frame_matches_single_rank(runs, block):
    ranks = runs["curved"]
    got = ranks[0][block]
    assert got["live"][1] > 0 and float(got["wsum"].max()) > 0.05
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[block]["sharded"], got["sharded"])
        assert r[block]["hashes"] == got["hashes"]
    np.testing.assert_allclose(got["sharded"], got["single"], atol=2e-4)

"""nerf_texture_tpu_torch: the PyTorch + CUDA port of nerf_texture_tpu.

The JAX package ``nerf_texture_tpu`` stays the reference; this package
mirrors its module paths and names (``render/renderer.py`` here is the
counterpart of ``nerf_texture_tpu/render/renderer.py``) and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
``torch`` and never ``jax`` or the JAX package.

What is ported so far: the Instant-NGP stage -- ``train.trainer.Trainer``
trains the field (march, sample pool, packed hash-grid encode with its
scatter backward, Adam, EMA, grid refresh), and ``render_frame`` renders
a view through the prepass, the proxy sweep and one of the two survivor
selection kernels of ``csrc/proxy_select.cu`` (``proxy_select_cdf`` or
``proxy_select``) -- and the serving path of the curved NeRF-Texture
model: ``train.curved_trainer.CurvedTrainer`` refreshes its density grid
through the per-cell anchor table and renders views through the proxy
path (``proxy_select_cdf``) or the pool path (``parity=True``).  Its
training (camera, gamma and error-map training, distillation), the
texture pipelines, checkpoints, captured ``transforms.json`` scenes and
the two training CLIs beside the package (``main_nerf_torch.py``,
``main_torch.py``) are ported too.

- ``geometry`` -- host mesh utilities (icosphere, UV atlas, TBN), the
                  grid index and kNN, the mesh projector's anchor frames
                  and per-cell anchor table
- ``native``   -- the grid index's tables: binning and per-cell nearest
                  items (CUDA kernels of ``csrc/spatial_build.cu`` + plain
                  twins)
- ``ops``      -- trunc_exp, frequency and SH encodings, packed hash-grid
                  encode (single and dual table) and its row
                  lookup/scatter autograd pair, the per-corner hash grid,
                  slab test, march and the background sphere's polar
                  coordinates, compositing, occupancy grid (refresh,
                  sparse refresh, mark_untrained, packbits), Morton codes,
                  proxy_select_cdf / proxy_select (CUDA kernels + plain
                  twins)
- ``models``   -- NGP (packed or per-corner encoder, learned background
                  sphere); the curved model: mesh field, normal net, SH
                  light, curved field
- ``render``   -- render_rays (training and the pool path, two-phase over
                  ``compact.survivor_pool``), the frame renderer
                  (prepass, proxy or pool chunks) and the importance-
                  sampling renderer
- ``data``     -- ray generation and sampling (uniform or by error map),
                  poses, the synthetic-sphere dataset and fixtures, the
                  ``transforms.json`` loader, PNG files and PIL's Lanczos
                  without an image library
- ``train``    -- TrainConfig, Trainer, train_step, grid_step,
                  render_frame, checkpoints; CurvedTrainConfig,
                  CurvedTrainer, curved_grid_step, distill_step,
                  load_ngp_teacher; field_io (the texture round trip)
- ``utils``    -- MLP, PSNR, rotations, the metrics log
- ``config``   -- SceneConfig and the scene presets
- ``convert``  -- JAX param / occupancy pytrees (as numpy) -> torch
- ``kernels``  -- nvcc build + ctypes load of ``csrc/*.cu``
"""

__version__ = "0.1.0"

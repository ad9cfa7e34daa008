"""nerf_texture_tpu_torch: the PyTorch + CUDA port of nerf_texture_tpu.

The JAX package ``nerf_texture_tpu`` stays the reference; this package
mirrors its module paths and names (``render/renderer.py`` here is the
counterpart of ``nerf_texture_tpu/render/renderer.py``) and is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
``torch`` and never ``jax`` or the JAX package.

What is ported so far is the serving path of the Instant-NGP model:
``train.trainer.render_frame`` renders a novel view through the
prepass, the proxy sweep, the ``proxy_select_cdf`` CUDA kernel
(``csrc/proxy_select.cu``) and the packed hash-grid field.

- ``ops``      -- trunc_exp, SH encoding, packed hash-grid encode
                  (forward), ray/AABB slab test, occupancy container,
                  proxy_select_cdf (CUDA kernel + plain twin)
- ``models``   -- NGP config, init and forward
- ``render``   -- the proxy inference renderer (prepass, chunk loop)
- ``data``     -- ray generation, orbit poses, synthetic-sphere fixtures
- ``train``    -- the NGP field functions and the serving render_frame
- ``convert``  -- JAX param / occupancy pytrees (as numpy) -> torch
- ``kernels``  -- nvcc build + ctypes load of ``csrc/*.cu``
"""

__version__ = "0.1.0"

"""Tiny MLPs (port of ``nerf_texture_tpu/utils/mlp.py``).

Parameters keep the JAX layout: a list of ``{"w": [in, out]}`` f32
tensors, with a ``"b": [out]`` f32 bias where the net has one (the NGP
nets have none, the curved model's have), added to the f32 product.
``apply_mlp`` reproduces the JAX numerics: operands rounded to bf16,
products accumulated in f32 (``jnp.dot(bf16, bf16,
preferred_element_type=f32)``), bf16 between layers.  PyTorch's bf16 matmul would return bf16, so the rounded
operands are multiplied as f32 instead.  bf16 values are exact in TF32,
so ``torch.backends.cuda.matmul.allow_tf32`` changes no product (at
most the order of the f32 sums).
"""

from __future__ import annotations

import math

import torch


def init_mlp(generator: torch.Generator, dims,
             bias: bool = False) -> list[dict[str, torch.Tensor]]:
    """He-initialised MLP params, dims = [in, h1, ..., out], on the
    generator's device; ``bias`` adds zero biases."""
    layers = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        device=generator.device)
        layer = {"w": w * math.sqrt(2.0 / dims[i])}
        if bias:
            layer["b"] = torch.zeros((dims[i + 1],),
                                     device=generator.device)
        layers.append(layer)
    return layers


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def apply_mlp(layers, x: torch.Tensor, *,
              final_activation=None) -> torch.Tensor:
    """Apply an MLP: bf16 operands, f32 accumulation (+ f32 bias), relu
    between layers, f32 result."""
    h = _round_bf16(x)
    n = len(layers)
    for i, layer in enumerate(layers):
        h = torch.matmul(h, _round_bf16(layer["w"]))
        if "b" in layer:
            h = h + layer["b"]
        if i < n - 1:
            h = _round_bf16(torch.relu(h))
    if final_activation is not None:
        h = final_activation(h)
    return h

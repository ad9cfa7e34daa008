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

Tensor parallelism (``parallel.sharding.shard_params``): a layer whose
weight carries ``tp_split`` holds this rank's slice of it, by output
columns (dim 1) or input rows (dim 0).  ``apply_mlp`` then runs
Megatron's scheme with two autograd operators over the mesh's model
group: ``copy_to_model`` (identity forward, all-reduce backward) before a
column layer, ``reduce_from_model`` (all-reduce forward, identity
backward) after a row layer.  A column layer adds its slice of the bias,
a row layer its bias once after the reduction, and a replicated layer
that follows a split activation gathers it first
(``gather_from_model``).  The numerics stay bf16 operands and f32
products; a row layer's partial sums are f32, summed across the ranks
in f32 (another order of the same sums).
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
    between layers, f32 result.  Layers split over a mesh's model axis
    run tensor-parallel (see the module docstring)."""
    if any(getattr(layer["w"], "tp_split", None) is not None
           for layer in layers):
        return _apply_mlp_tp(layers, x, final_activation)
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


# ---------------------------------------------------------------------------
# tensor parallelism over a mesh's model axis
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the cotangent over
    the model group backward (the consumers of x are split)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce over the model group forward (the sum of
    the ranks' partial products), identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """A column-split activation [N, k] -> the whole [N, k * model]:
    forward an all-reduce of a zeroed buffer holding this rank's
    columns, backward the rank's columns of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.k = mesh, x.shape[-1]
        m = mesh.shape["model"]
        buf = x.new_zeros(x.shape[:-1] + (ctx.k * m,))
        buf[..., mesh.model_index * ctx.k:(mesh.model_index + 1) * ctx.k] = x
        return mesh.all_reduce(buf, "model")

    @staticmethod
    def backward(ctx, g):
        i, k = ctx.mesh.model_index, ctx.k
        return g[..., i * k:(i + 1) * k].contiguous(), None


def copy_to_model(x, mesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh):
    return _GatherFromModel.apply(x, mesh)


def model_columns(x, mesh, width: int):
    """This rank's ``width`` last-axis entries of a replicated tensor,
    through ``copy_to_model`` (its consumers are split)."""
    i = mesh.model_index
    return copy_to_model(x, mesh)[..., i * width:(i + 1) * width]


def tp_layers(layers, x, linear):
    """The tensor-parallel walk over ``layers``: ``linear(layer, h, tp,
    mesh, last=)`` applies one layer (its activation too, unless
    ``last``) to an input that the walk has made whole (replicated and
    column layers) or split by columns (row layers), and returns its
    output (split after a column layer).  Returns the whole output."""
    h, split, mesh = x, False, None
    n = len(layers)
    for i, layer in enumerate(layers):
        tp = getattr(layer["w"], "tp_split", None)
        if tp is not None:
            mesh = tp.mesh
        if split and (tp is None or tp.dim == 1):
            h, split = gather_from_model(h, mesh), False
        if tp is not None and tp.dim == 0 and not split:
            h = model_columns(h, mesh, layer["w"].shape[0])
        h = linear(layer, h, tp, mesh, last=(i == n - 1))
        split = tp is not None and tp.dim == 1
    if split:
        h = gather_from_model(h, mesh)
    return h


def _apply_mlp_tp(layers, x, final_activation):
    def linear(layer, h, tp, mesh, last):
        if tp is not None and tp.dim == 1:
            h = copy_to_model(h, mesh)
        h = torch.matmul(h, _round_bf16(layer["w"]))
        if tp is not None and tp.dim == 0:
            h = reduce_from_model(h, mesh)
        if "b" in layer:
            b = layer["b"]
            if tp is not None and tp.dim == 1:
                b = model_columns(b, mesh, layer["w"].shape[1])
            h = h + b
        return h if last else _round_bf16(torch.relu(h))

    h = tp_layers(layers, _round_bf16(x), linear)
    if final_activation is not None:
        h = final_activation(h)
    return h

"""Rank processes for the multi-rank tests of the PyTorch port.

``run_ranks(job, world, payload, tmp)`` starts ``world`` processes (fresh
interpreters that import torch and the port, never jax), each of which
joins a gloo process group through a ``file://`` store in ``tmp`` (so
test files running side by side share no port), runs ``job(rank, world,
payload)`` and saves what it returns.
A deadline bounds the whole run: ranks still alive when it passes are
killed and the call raises, so a deadlock fails its test instead of
hanging the suite.  The jobs live here, in a module without jax, so that
the children import it quickly.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

TIMEOUT = 60.0          # the process group's collective timeout, seconds


def _entry(name, rank, world, store, payload_path, out_path):
    torch.set_num_threads(1)
    from nerf_texture_tpu_torch.parallel import initialize_multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(k, None)
    ok = initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                              timeout=TIMEOUT)
    again = initialize_multihost(f"file://{store}", world, rank,
                                 backend="gloo")
    try:
        res = globals()[name](rank, world,
                              torch.load(payload_path, weights_only=False))
        res["initialized"] = (ok, again)
        torch.save(res, out_path)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); import torch_ranks; "
          "torch_ranks._entry(sys.argv[2], int(sys.argv[3]), "
          "int(sys.argv[4]), *sys.argv[5:])")


class Ranks:
    """Rank processes started by ``start_ranks``; ``wait()`` joins them
    within their deadline and returns their results in rank order."""

    def __init__(self, job, world: int, payload, tmp, deadline: float):
        tmp = str(tmp)
        self.tag = tag = f"{job.__name__}_{world}"
        pay = os.path.join(tmp, tag + ".payload")
        torch.save(payload, pay)
        self.outs = [os.path.join(tmp, f"{tag}_{r}.pt") for r in range(world)]
        here = os.path.dirname(os.path.abspath(__file__))
        self.logs = [open(o + ".log", "w") for o in self.outs]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, here, job.__name__, str(r),
             str(world), os.path.join(tmp, tag + ".store"), pay,
             self.outs[r]],
            cwd=os.path.dirname(here), stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        self.deadline = deadline
        self.end = time.monotonic() + deadline

    def wait(self) -> list[dict]:
        hung = []
        for r, p in enumerate(self.procs):
            try:
                p.wait(max(0.0, self.end - time.monotonic()))
            except subprocess.TimeoutExpired:
                hung.append(r)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        text = "\n".join(open(o + ".log").read()[-3000:] for o in self.outs)
        if hung:
            raise AssertionError(f"ranks {hung} of {self.tag} still running "
                                 f"after {self.deadline} s (killed)\n{text}")
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"ranks {bad} of {self.tag} failed\n{text}")
        return [torch.load(o, weights_only=False) for o in self.outs]


def start_ranks(job, world: int, payload, tmp, deadline: float = 300.0
                ) -> Ranks:
    """Start ``job`` (a function of this module) on ``world`` gloo ranks
    in the background."""
    return Ranks(job, world, payload, tmp, deadline)


def run_ranks(job, world: int, payload, tmp, deadline: float = 300.0
              ) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks; their results in rank order."""
    return start_ranks(job, world, payload, tmp, deadline).wait()


def _np(t):
    return t.detach().cpu().numpy().copy()


def flat_tree(tree, prefix=()):
    """{path: tensor} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat_tree(tree[k],
                                                         prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in flat_tree(x, prefix + (i,)).items()}
    return {prefix: tree}


def gathered(tree, values=None) -> dict:
    """{path: whole numpy array} of a params tree's leaves, or of
    ``values(leaf)`` split like each leaf (a collective over the model
    group: every rank calls it)."""
    from nerf_texture_tpu_torch.parallel.train import gathered_leaf

    out = {}
    for path, p in flat_tree(tree).items():
        x = p if values is None else values(p)
        out[path] = _np(gathered_leaf(p, x))
    return out


def state_hashes(state) -> dict:
    """A hash of every whole leaf of the params, Adam moments and EMA and
    of the grid: equal hashes on two ranks mean bitwise-equal state."""
    import hashlib

    ema = flat_tree(state.ema_params)
    params = flat_tree(state.params)
    out = {}
    for name, values in (
            ("params", None),
            ("exp_avg", lambda p: state.optimizer.state[p]["exp_avg"]),
            ("exp_avg_sq", lambda p: state.optimizer.state[p]["exp_avg_sq"]),
            ("ema", lambda p: ema[_path_of(params, p)])):
        for path, a in gathered(state.params, values).items():
            out[(name,) + path] = hashlib.sha1(a.tobytes()).hexdigest()
    for i, t in enumerate(state.occ):
        out[("occ", i)] = hashlib.sha1(_np(t).tobytes()).hexdigest()
    return out


def _path_of(params: dict, leaf) -> tuple:
    return next(k for k, v in params.items() if v is leaf)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def ngp_dp_job(rank, world, payload):
    """NGP ``dp_train_step`` on a data x model mesh: every step's loss,
    the reduced gradients and params after the first step and the params
    after the last (rank 0), and every rank's state hashes."""
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_state

    mesh = make_mesh(payload["data"], payload["model"], device="cpu")
    state = shard_state(ngp_state(payload), mesh)
    res = {"coords": (mesh.data_index, mesh.model_index),
           "backend": mesh.backend}
    res["losses"] = ngp_steps(state, payload, mesh, res if rank == 0
                              else None)
    params = gathered(state.params)
    if rank == 0:
        res["params"] = params
    res["hashes"] = state_hashes(state)
    return res


def ngp_state(payload):
    from nerf_texture_tpu_torch.convert import params_from_jax
    from nerf_texture_tpu_torch.ops import occupancy as tocc
    from nerf_texture_tpu_torch.train import trainer as tt

    cfg = payload["cfg"]
    st = tt.init_train_state(torch.Generator(), cfg["mcfg"], cfg["rcfg"],
                             cfg["tcfg"], params=params_from_jax(
                                 payload["params"], device="cpu"))
    st.occ = tocc.create(cfg["rcfg"].grid_size, 1, device="cpu")
    st.occ = st.occ._replace(occ=torch.ones_like(st.occ.occ))
    return st


def ngp_steps(state, payload, mesh, first=None):
    """The payload's steps (one a march-jitter draw); ``first`` (a dict)
    gets the whole gradients and params after the first step."""
    from nerf_texture_tpu_torch.parallel import dp_train_step

    cfg = payload["cfg"]
    b = {k: torch.tensor(v) for k, v in payload["batch"].items()}
    losses = []
    for i, u in enumerate(payload["us"]):
        loss = dp_train_step(state, b["rays_o"], b["rays_d"], b["gt"],
                             torch.ones(3), torch.tensor(u), mesh=mesh,
                             **cfg)
        losses.append(float(loss))
        if i == 0:
            grads = gathered(state.params, lambda p: p.grad)
            params = gathered(state.params)
            if first is not None:
                first["grads1"], first["params1"] = grads, params
    return losses


def tp_mlp_job(rank, world, payload):
    """The tensor-parallel MLP and Lipschitz MLP over a model-only mesh:
    outputs and whole gradients (inputs and every weight)."""
    from nerf_texture_tpu_torch.convert import params_from_jax
    from nerf_texture_tpu_torch.models.normal_net import apply_lip_mlp
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_params
    from nerf_texture_tpu_torch.parallel.train import gathered_leaf
    from nerf_texture_tpu_torch.utils.mlp import apply_mlp

    mesh = make_mesh(1, world, device="cpu")
    out = {}
    for name, apply in (("mlp", apply_mlp), ("lip", apply_lip_mlp)):
        tree = shard_params({"net": params_from_jax(payload[name],
                                                    device="cpu")}, mesh)
        for p in flat_tree(tree).values():
            p.requires_grad_(True)
        x = torch.from_numpy(payload["x_" + name]).requires_grad_(True)
        y = apply(tree["net"], x)
        torch.sum(y * torch.from_numpy(payload["cot_" + name])).backward()
        out[name] = {"y": _np(y), "gx": _np(x.grad),
                     "grads": {k: _np(gathered_leaf(p, p.grad))
                               for k, p in flat_tree(tree).items()},
                     "split": {k: getattr(p, "tp_split", None) is not None
                               for k, p in flat_tree(tree).items()}}
    return out


def render_job(rank, world, payload):
    """``render_image_sharded`` over a data-only mesh for each case of the
    payload: (name, params, occ, density or None, config); with the
    config's ``deferred``, the NGP's deferred stages."""
    from nerf_texture_tpu_torch.convert import params_from_jax
    from nerf_texture_tpu_torch.parallel import make_mesh
    from nerf_texture_tpu_torch.parallel.eval import render_image_sharded
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        render_image)
    from nerf_texture_tpu_torch.train.trainer import (ngp_deferred_s1,
                                                      ngp_deferred_s2,
                                                      ngp_field_apply)

    mesh = make_mesh(world, 1, device="cpu")
    out = {}
    for name, case in payload["cases"].items():
        params = params_from_jax(case["params"], device="cpu")
        occ = torch.tensor(case["occ"])
        dens = case.get("density")
        dens = None if dens is None else torch.tensor(dens)
        deferred = ((ngp_deferred_s1, ngp_deferred_s2)
                    if case["rcfg"].deferred else None)
        res = render_image_sharded(
            ngp_field_apply, case["mcfg"], params, occ, case["pose"],
            case["intr"], case["H"], case["W"], case["rcfg"], mesh,
            density=dens, deferred_apply=deferred)
        out[name] = {"image": _np(res["image"]),
                     "weights_sum": _np(res["weights_sum"]),
                     "chunks": res["chunks"]}
        if dens is not None:
            with torch.no_grad():
                single = render_image(
                    ngp_field_apply, case["mcfg"], params,
                    PrepassState.build(occ, case["rcfg"], density=dens),
                    case["pose"], case["intr"], case["H"], case["W"],
                    case["rcfg"], deferred_apply=deferred)
            out[name]["single"] = _np(single["image"])
            out[name]["single_live"] = single["live"]
    return out


# ---------------------------------------------------------------------------
# the curved model
# ---------------------------------------------------------------------------

def curved_setup(payload):
    """The port's curved state (the payload's JAX params and grid) and
    its template's field state, on the CPU."""
    from nerf_texture_tpu_torch.convert import (occupancy_from_jax,
                                                params_from_jax)
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field as tmf
    from nerf_texture_tpu_torch.train import curved_trainer as tct

    cfg = payload["cfg"]
    st = tct.init_curved_state(torch.Generator(), cfg["ccfg"], cfg["rcfg"],
                               cfg["tcfg"], params=params_from_jax(
                                   payload["params"], device="cpu"),
                               n_frames=payload["images"].shape[0])
    st.occ = occupancy_from_jax(*payload["occ"], device="cpu")
    fstate = tmf.make_state(MeshProjector(
        make_icosphere(payload["ico"], radius=0.5), device="cpu"))
    return st, fstate


def curved_steps(state, fstate, payload, mesh, first=None):
    """The payload's curved steps (one a CurvedBatch of draws); ``first``
    gets the whole gradients after the first step."""
    from nerf_texture_tpu_torch.train import curved_trainer as tct

    cfg = payload["cfg"]
    poses, images = (torch.tensor(payload[k]) for k in ("poses", "images"))
    intr = torch.tensor(payload["intrinsics"])
    losses = []
    for i, batch in enumerate(payload["batches"]):
        m = tct.curved_train_step(
            state, batch, fstate, poses, images, intr, ccfg=cfg["ccfg"],
            rcfg=cfg["rcfg"], tcfg=cfg["tcfg"], H=payload["H"],
            W=payload["W"], mode="none", rt=None, mesh=mesh)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = gathered(state.params, lambda p: p.grad)
            if first is not None:
                first["grads1"] = grads
    return losses


def curved_dp_job(rank, world, payload):
    """``curved_train_step(mesh=)`` for each run of the payload (a data x
    model mesh each): losses, the first step's gradients, the params and
    error map after the last step (rank 0), every rank's state hashes."""
    from nerf_texture_tpu_torch.parallel import make_mesh, shard_curved_state

    out = {}
    for name, run in payload["runs"].items():
        mesh = make_mesh(run["data"], run["model"], device="cpu")
        st, fstate = curved_setup(run)
        st, fstate = shard_curved_state(st, fstate, mesh)
        res = {}
        res["losses"] = curved_steps(st, fstate, run, mesh, res)
        params = gathered(st.params)
        res["hashes"] = state_hashes(st)
        res["emap"] = _np(st.error_map)
        if rank == 0:
            res["params"] = params
        else:
            res.pop("grads1")
        out[name] = res
    return out


def curved_frames_job(rank, world, payload):
    """A curved trainer (seeded, a few steps on the CPU, identical on
    every rank) rendered by ``render_image_sharded`` over a data-only
    mesh and by the single-rank ``render_image``, at each render config
    of the payload."""
    from nerf_texture_tpu_torch.geometry.mesh import make_icosphere
    from nerf_texture_tpu_torch.geometry.projector import MeshProjector
    from nerf_texture_tpu_torch.models import mesh_field as tmf
    from nerf_texture_tpu_torch.parallel import make_mesh
    from nerf_texture_tpu_torch.parallel.eval import render_image_sharded
    from nerf_texture_tpu_torch.render.renderer import (PrepassState,
                                                        render_image)
    from nerf_texture_tpu_torch.train import curved_trainer as tct

    mesh = make_mesh(world, 1, device="cpu")
    ds = payload["dataset"]
    tr = tct.CurvedTrainer(ds, tmf.make_state(MeshProjector(
        make_icosphere(2, radius=0.5), device="cpu")), payload["ccfg"],
        payload["rcfgs"][0], payload["tcfg"], seed=0, device="cpu")
    tr.initialize_states(1)
    tr.train(payload["steps"])
    static = (tr.ccfg, tr.mode, "RGB", "Full")
    bundle = {"params": tr._infer_params(tr.state.params),
              "field_state": tr.field_state, "rt": tr.runtime,
              "anchor_tab": tr._anchor_table()}
    occ = tr.state.occ
    out = {}
    for i, rcfg in enumerate(payload["rcfgs"]):
        kw = dict(anchor_apply=tct.curved_anchor_apply)
        sharded = render_image_sharded(
            tct.curved_field_apply, static, bundle, occ.occ, ds.poses[0],
            ds.intrinsics, ds.H, ds.W, rcfg, mesh, density=occ.density,
            **kw)
        with torch.no_grad():
            single = render_image(
                tct.curved_field_apply, static, bundle,
                PrepassState.build(occ.occ, rcfg, density=occ.density),
                ds.poses[0], ds.intrinsics, ds.H, ds.W, rcfg, **kw)
        out[i] = {"sharded": _np(sharded["image"]),
                  "single": _np(single["image"]),
                  "wsum": _np(single["weights_sum"]),
                  "live": (sharded["live"], single["live"]),
                  "hashes": state_hashes(tr.state)}
    return out


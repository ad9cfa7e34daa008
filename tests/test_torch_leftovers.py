"""The last public functions of the JAX package that the PyTorch port
lacked, each against its JAX counterpart, and a census that every public
top-level name of the JAX package has one in the port.

Tolerances, each with its reason:
- ``rand_poses`` (host numpy on the same ``np.random.Generator``),
  ``PSNRMeter`` (host numpy), ``cell_index`` (integer math) and the
  curved ``init_state``'s per-frame leaves: exact;
- ``biased_softplus``: 1e-6 (torch's softplus is linear beyond 20, JAX's
  ``logaddexp`` adds exp(-x) there);
- ``chunk_points`` with JAX's jitter: 1e-6 (the same f32 cell centres);
- ``update_host`` on a converted NGP with JAX's key draws: the masks
  exact and the densities within 1e-5 relative on >= 99% of the cells
  (the port's grid-refresh bound: bf16 table rows and activations on both
  sides can round to the neighbouring value after a last-bit
  difference);
- ``packed_encode_pair`` / ``_bound_pair``: the features within 1e-6 and
  each table's gradient within 1e-5 of its largest entry against
  ``jax.vjp`` (f32 sums in another order);
- ``curved_train_scan(K=3)``: equal to three ``curved_train_step`` calls
  bit for bit (the same ops in the same order), and its last and mean
  loss within 1e-2 of JAX's scan over the same draws (the lockstep
  bound of tests/test_torch_curved_train.py for the first refresh cycle).
"""

import dataclasses
import importlib
import inspect
import json
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_texture_tpu.data import poses as jposes
from nerf_texture_tpu.models import ngp as jngp
from nerf_texture_tpu.ops import activation as jact
from nerf_texture_tpu.ops import hashgrid_packed as jhp
from nerf_texture_tpu.ops import occupancy as jocc
from nerf_texture_tpu.train import curved_trainer as jct
from nerf_texture_tpu.utils import metrics as jmetrics
from nerf_texture_tpu_torch.convert import params_from_jax
from nerf_texture_tpu_torch.data import poses as tposes
from nerf_texture_tpu_torch.models import ngp as tngp
from nerf_texture_tpu_torch.ops import activation as tact
from nerf_texture_tpu_torch.ops import hashgrid_packed as thp
from nerf_texture_tpu_torch.ops import occupancy as tocc
from nerf_texture_tpu_torch.train import curved_trainer as tct
from nerf_texture_tpu_torch.utils import metrics as tmetrics
from nerf_texture_tpu_torch.utils.misc import profile_trace


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads beside JAX's pools (as the other test files
    that import both packages)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(radius=2.5, theta_range=(0.3, 1.0),
                                         phi_range=(1.0, 2.0))])
def test_rand_poses_matches_jax(kw):
    got = tposes.rand_poses(np.random.default_rng(7), 9, **kw)
    want = jposes.rand_poses(np.random.default_rng(7), 9, **kw)
    assert got.shape == (9, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_psnr_meter_matches_jax():
    rng = np.random.default_rng(1)
    mt, mj = tmetrics.PSNRMeter(), jmetrics.PSNRMeter()
    assert mt.average == mj.average == 0.0
    for _ in range(4):
        a, b = rng.random((8, 8, 3)), rng.random((8, 8, 3))
        mt.update(torch.as_tensor(a), b)
        mj.update(a, b)
    mt.update(a, a)                     # equal images: 99 dB
    mj.update(a, a)
    assert mt.n == mj.n == 5
    assert mt.average == mj.average
    mt.clear()
    assert (mt.v, mt.n, mt.average) == (0.0, 0, 0.0)


@pytest.mark.parametrize("bias", [0.0, -1.0, 2.5])
def test_biased_softplus_matches_jax(bias):
    x = np.random.default_rng(2).normal(0, 8, (4096,)).astype(np.float32)
    x[:4] = [-60.0, 19.0, 25.0, 60.0]
    got = _np(tact.biased_softplus(torch.as_tensor(x), bias))
    want = np.asarray(jact.biased_softplus(jnp.asarray(x), bias))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the occupancy grid's host chunk loop
# ---------------------------------------------------------------------------

def test_cell_index_and_chunk_points_match_jax():
    H = 16
    c = np.random.default_rng(3).integers(0, H, (100, 3))
    np.testing.assert_array_equal(
        _np(tocc.cell_index(torch.as_tensor(c), H)),
        np.asarray(jocc.cell_index(jnp.asarray(c), H)))
    # the last chunk runs past the grid: its ids clamp to the last cell
    for start, cas, bound in ((0, 0, 1.0), (H ** 3 - 300, 1, 2.0)):
        key = jax.random.PRNGKey(start + cas)
        want = np.asarray(jocc.chunk_points(jnp.asarray(start), key,
                                            grid_size=H, cas=cas,
                                            bound=bound, chunk=512))
        half = min(2 ** cas, bound) / H
        noise = jax.random.uniform(key, (512, 3), minval=-half, maxval=half)
        got = tocc.chunk_points(start, torch.tensor(np.asarray(noise)),
                                grid_size=H, cas=cas, bound=bound, chunk=512)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)


UPDATE = dict(grid_size=16, cascades=2, density_thresh=1.0, decay=0.85,
              chunk=1000)
NGP_KW = dict(bound=2.0, num_levels=4, level_dim=2, log2_bricks=10,
              desired_resolution=128)


def _host_draws_of(key, grid_size, cascades, bound, chunk):
    """The jitter JAX's ``update_host`` draws from ``key``: one split a
    chunk, cascade by cascade, as ``host_draws``' layout."""
    out = []
    for cas in range(cascades):
        half = min(2 ** cas, bound) / grid_size
        parts = []
        for _ in range(0, grid_size ** 3, chunk):
            key, k = jax.random.split(key)
            parts.append(np.asarray(jax.random.uniform(
                k, (chunk, 3), minval=-half, maxval=half)))
        out.append(torch.as_tensor(np.concatenate(parts)))
    return out


def test_update_host_matches_jax():
    H, bound = UPDATE["grid_size"], NGP_KW["bound"]
    kw = dict(grid_size=H, cascades=UPDATE["cascades"], bound=bound,
              chunk=UPDATE["chunk"])
    pj = jngp.init(jax.random.PRNGKey(0), jngp.NGPConfig(**NGP_KW))
    pj = {**pj, "grid": pj["grid"] * 3e3}   # so that sigma varies
    pt = params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    mj, mt = jngp.NGPConfig(**NGP_KW), tngp.NGPConfig(**NGP_KW)

    def sig_j(start, k, cas):
        x = jocc.chunk_points(start, k, grid_size=H, cas=cas, bound=bound,
                              chunk=UPDATE["chunk"])
        return jngp.density(pj, x, mj)[0]

    def sig_t(start, noise, cas):
        x = tocc.chunk_points(start, noise, grid_size=H, cas=cas,
                              bound=bound, chunk=UPDATE["chunk"])
        return tngp.density(pt, x, mt)[0]

    ukw = {k: UPDATE[k] for k in ("grid_size", "cascades", "density_thresh",
                                  "decay", "chunk")}
    sj = jocc.create(H, UPDATE["cascades"])
    # untrained cells stay at -1 through the EMA
    sj = sj._replace(density=sj.density.at[0, :64].set(-1.0))
    st = tocc.OccupancyGrid(*(torch.tensor(np.asarray(a)) for a in sj))
    for i in range(2):                  # a first refresh, then the EMA
        key = jax.random.PRNGKey(20 + i)
        sj = jocc.update_host(sj, sig_j, key, **ukw)
        st = tocc.update_host(st, sig_t, _host_draws_of(key, **kw), **ukw)
        d_t, d_j = _np(st.density), np.asarray(sj.density)
        off = np.abs(d_t - d_j) > 1e-5 * np.abs(d_j) + 1e-7
        assert off.mean() <= 0.01, off.mean()
        np.testing.assert_array_equal(_np(st.occ), np.asarray(sj.occ))
        assert 0 < np.asarray(sj.occ).mean() < 1
        assert (d_j[0, :64] == -1).all() and (d_t[0, :64] == -1).all()
        np.testing.assert_allclose(float(st.mean_density),
                                   float(sj.mean_density), rtol=1e-4)
        assert int(st.iter_density) == int(sj.iter_density) == i + 1
    # host_draws: the layout update_host reads, on the generator's device
    draws = tocc.host_draws(torch.Generator().manual_seed(0), **kw)
    n = -(-H ** 3 // UPDATE["chunk"]) * UPDATE["chunk"]
    assert [tuple(d.shape) for d in draws] == [(n, 3)] * 2
    assert float(draws[0].abs().max()) <= 1.0 / H    # half a cell of 2 / H
    assert 1.0 / H < float(draws[1].abs().max()) <= 2.0 / H


# ---------------------------------------------------------------------------
# the two-table packed encode
# ---------------------------------------------------------------------------

SPEC = dict(num_levels=4, level_dim=2, base_resolution=8, log2_bricks=8,
            desired_resolution=64)


@pytest.mark.parametrize("bound", [None, 1.5])
def test_packed_encode_pair_matches_jax(bound):
    sj, st = jhp.PackedGridSpec(**SPEC), thp.PackedGridSpec(**SPEC)
    rng = np.random.default_rng(4)
    ta = rng.normal(0, 1, (sj.table_rows, sj.storage_width)).astype(
        np.float32)
    tb = rng.normal(0, 1, ta.shape).astype(np.float32)
    lo, hi = (-0.05, 1.05) if bound is None else (-1.6, 1.6)
    x = rng.uniform(lo, hi, (2, 300, 3)).astype(np.float32)  # some outside
    ga = rng.normal(0, 1, (2, 300, sj.output_dim)).astype(np.float32)
    gb = rng.normal(0, 1, ga.shape).astype(np.float32)
    if bound is None:
        def fj(a, b):
            return jhp.packed_encode_pair(jnp.asarray(x), a, b, sj)
        fwd = thp.packed_encode_pair
        args = ()
    else:
        def fj(a, b):
            return jhp.packed_encode_bound_pair(jnp.asarray(x), a, b, sj,
                                                bound=bound)
        fwd = thp.packed_encode_bound_pair
        args = (bound,)
    (oa_j, ob_j), vjp = jax.vjp(fj, jnp.asarray(ta), jnp.asarray(tb))
    da_j, db_j = vjp((jnp.asarray(ga), jnp.asarray(gb)))
    ta_t = torch.tensor(ta, requires_grad=True)
    tb_t = torch.tensor(tb, requires_grad=True)
    oa, ob = fwd(torch.as_tensor(x), ta_t, tb_t, st, *args)
    assert oa.shape == ob.shape == (2, 300, st.output_dim)
    np.testing.assert_allclose(_np(oa), np.asarray(oa_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ob), np.asarray(ob_j), rtol=0, atol=1e-6)
    assert float((oa == 0).all(-1).float().mean()) > 0   # the zeroed points
    torch.sum(oa * torch.as_tensor(ga) + ob * torch.as_tensor(gb)).backward()
    for got, want in ((ta_t.grad, da_j), (tb_t.grad, db_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    # the pair is the two single-table encodes
    single = thp.packed_encode if bound is None else thp.packed_encode_bound
    np.testing.assert_allclose(
        _np(oa), _np(single(torch.as_tensor(x), torch.as_tensor(ta), st,
                            *args)), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# curved_train_scan and init_state
# ---------------------------------------------------------------------------

def test_curved_train_scan_matches_steps_and_jax():
    import test_torch_curved_train as C

    setup = C._make_setup()
    tj, cj, rj, tcfg = setup["tj"], setup["cj"], setup["rj"], \
        setup["tj_cfg"]
    frames = [0, 2, 3]
    key = jax.random.PRNGKey(5)
    js, mj = jct.curved_train_scan(
        tj.state, tj.field_state, tj.poses, tj.images, tj.intrinsics,
        jnp.asarray(frames), key, ccfg=cj, rcfg=rj, tcfg=tcfg, H=C.HW,
        W=C.HW, mode="none", rt=tj.runtime, anchor_tab=setup["tab_j"])
    batches = [C._batch(k, f, tcfg)
               for k, f in zip(jax.random.split(key, len(frames)), frames)]
    poses, images, intr = C._data(setup)
    scanned = C._port_state(setup, tj.state)
    state, m = tct.curved_train_scan(scanned, batches, setup["st"], poses,
                                     images, intr, **C._step_kw(setup))
    assert state is scanned and scanned.step == 3
    stepped = C._port_state(setup, tj.state)
    losses = [tct.curved_train_step(stepped, b, setup["st"], poses, images,
                                    intr, **C._step_kw(setup))["loss"]
              for b in batches]
    assert torch.equal(m["loss"], losses[-1])
    assert torch.equal(m["loss_mean"], torch.stack(losses).mean())
    for a, b in zip(tct.param_leaves(scanned.params),
                    tct.param_leaves(stepped.params)):
        assert torch.equal(a, b)
    assert int(js.step) == 3
    assert abs(float(m["loss"]) - float(mj["loss"])) <= 1e-2
    assert abs(float(m["loss_mean"]) - float(mj["loss_mean"])) <= 1e-2


def test_curved_init_state_matches_jax():
    import test_torch_curved_train as C

    cj, ct, rj, rt, _, _ = C._configs()
    kw = dict(optimize_camera=True, optimize_gamma=True)
    tj = dataclasses.replace(jct.CurvedTrainConfig(**C.TRAIN), **kw)
    tt = dataclasses.replace(tct.CurvedTrainConfig(**C.TRAIN), **kw)
    want = jct.init_state(jax.random.PRNGKey(0), cj, rj, tj, 5)
    got = tct.init_state(torch.Generator().manual_seed(0), ct, rt, tt, 5)
    fw, fg = C._flat(jax.tree.map(np.asarray, want.params)), \
        C._flat(got.params)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert fw[k].shape == fg[k].shape, k
    for k in (("camera", "dRs"), ("camera", "dts"), ("camera", "dfs"),
              ("gammas",)):
        np.testing.assert_array_equal(fg[k], fw[k])
    assert got.step == 0 and int(want.step) == 0
    assert tuple(got.occ.density.shape) == tuple(want.occ.density.shape)


# ---------------------------------------------------------------------------
# the profiler context and the census of public names
# ---------------------------------------------------------------------------

def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "t")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    with open(tmp_path / "t" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


# what the port leaves out on purpose (ROADMAP Queue 1, item 12): the
# TPU dispatch helpers
NO_COUNTERPART = {"nerf_texture_tpu.utils.misc": {
    "dput", "machine_scoped_cache_dir"}}


def test_every_public_name_has_a_counterpart():
    import nerf_texture_tpu as J

    missing = []
    for m in pkgutil.walk_packages(J.__path__, J.__name__ + "."):
        skip = NO_COUNTERPART.get(m.name, set())
        if skip is None:
            continue
        mod = importlib.import_module(m.name)
        port = importlib.import_module(
            m.name.replace("nerf_texture_tpu", "nerf_texture_tpu_torch", 1))
        for k, v in vars(mod).items():
            if k.startswith("_") or k in skip or inspect.ismodule(v):
                continue
            # names the module imports from elsewhere are that module's
            if (inspect.isfunction(v) or inspect.isclass(v)) \
                    and v.__module__ != m.name:
                continue
            if not hasattr(port, k):
                missing.append(f"{m.name}.{k}")
    assert not missing, missing

"""Training over a model axis and a pod axis (``launch.mesh.TrainMesh``,
``make_train_step(..., mesh=)``, ``launch/train.py --mesh DxM`` and
``PxDxM``) against the JAX package's no-mesh ``make_train_step`` on the
whole global batch, on the CPU over gloo.

The model is ``reduced_config(granite-3-2b)`` (2 layers, d 128, 4/2 heads
of 32, d_ff 256, vocab 512, float32) with the JAX package's seeded
weights carried across by ``bridge.state_from_numpy``; batches of 12 rows
of 16 tokens.  Meshes ``1x2`` and ``2x2`` (data x model), ``2x1x2`` and
``2x2x1`` (pod x data x model): under a model axis the projections split
Megatron-style (q/k/v and gate/up by output column, ``wo`` and ``w_down``
by input row, the head by vocab column, the 512-row embedding by vocab
row), each block of a leaf also cut over data where the data axis holds
more than one rank, and the batch runs over pod x data.  Modes
``float``, ``exact_quant`` and ``lowrank``, with the band regularizer on
and off.

Tolerances, those of ``tests/test_torch_dp.py``:

* the loss and every metric against JAX's step: rtol 1e-5 (the loss) and
  1e-4 (the others);
* the new moments against JAX's: 1e-3 (float) or 2**-6 (quantized) of
  each leaf's largest; the new parameters within 2.1 lr, and 1e-3 lr
  where the moment is sure;
* the new moments against the port's own one-device step: 2**-9 of each
  leaf's largest (float everywhere; quantized without a model axis), but
  2**-7 for a quantized mode under a model axis, the tightest power of
  two every step here holds (exact_quant 0.0064 of a leaf's largest,
  lowrank 0.0045, the same at 1x2, 2x2 and 2x1x2).  A row split sums its
  float32 partial products ``y_lin`` over the model ranks, whose last bit
  can part from one device's single product, and the value
  ``y_lin + (y_int - y_lin)`` keeps that bit, so an activation's
  per-tensor range can move by an ulp and its codes flip downstream; and
  a column split's input cotangent, summed over the model ranks in
  float32 before its one rounding to bf16, can round to the neighbouring
  bf16 value.  Nothing is summed twice or dropped: that would show as a
  factor of two, and the float steps, through the same sums, hold 2**-9.

Beside that: the fused q/k/v and gate/up at 2x2 against the unfused 2x2
step, ``remat`` and ``microbatch`` 2 through K1's wrapper, the
collectives, K1 calls, K1's (M, K, N) and state bytes per rank and step
against ``launch/dryrun``'s counts, gradient compression at 2x1x2, a
checkpoint written at 2x2 restored at one device, at a data axis of 4, at
2x1x2 and into the JAX package, the preemption flag agreed by every rank,
the launcher at ``--mesh 2x2`` then ``--mesh 4`` resuming, the reduced
qwen2-moe-a2.7b at 2x2x1 (its routing over the batch group equal to JAX's
on the global batch in every layer), the refusals, and the optimizer
state's specs on a pod mesh against JAX's ``opt_state_shardings``.

One world of 4 ranks is spawned once per module; every mesh is carved
from it (``launch.mesh.carve_mesh``) and runs every case of its shape.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import signal
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.launch.dryrun import (collectives_per_train_step, k1_per_train_step,
                                       k1_shapes_per_rank, state_bytes_per_rank)
from repro_torch.launch.mesh import (DataMesh, MeshShape, carve_mesh, mesh_ranks, parse_mesh,
                                     run_ranks)
from repro_torch.models.attention import TPHeadsError
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import COUNTS
from repro_torch.parallel.sharding import opt_state_pspecs, param_pspecs, tree_bytes
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.fault import PreemptionGuard
from repro_torch.train.tree import leaves

from test_torch_dp_families import case as family_case
from test_torch_dp_families import check_against_jax, jax_init, jax_step, port_cfg, step_case
from test_torch_dp_families import batch_np as family_batch
from test_torch_dp_moe import RouteLog, jax_routing

ARCH = "granite-3-2b"
BATCH, SEQ = 12, 16
MODES = ("float", "exact_quant", "lowrank")
BANDS = (0.0, 1e-4)
QUANT_TOL, FLOAT_TOL = 2.0 ** -6, 1e-3
ONE_DEVICE_TOL, MODEL_AXIS_TOL = 2.0 ** -9, 2.0 ** -7        # see the module text
ADAMW = dict(kind="adamw", lr=1e-3, warmup_steps=0, total_steps=10)
SGD = dict(kind="sgd", lr=1e-2, warmup_steps=0, total_steps=10)
SHAPES = ("1x2", "2x2", "2x1x2", "2x2x1")
SAVED, SAVED_AT = "lowrank-0.0001", "2x2"          # the checkpointed case and its mesh
_WORLD_TIMEOUT = 150


def _case(name, mode, band, *, port_mode=None, microbatch=1, remat=False, fused=False,
          compression=False, opt=ADAMW, meshes=SHAPES):
    return {"name": name, "mode": mode, "port_mode": port_mode or mode, "band": band,
            "microbatch": microbatch, "remat": remat, "fused": fused,
            "compression": compression, "opt": opt, "meshes": meshes}


MODE_CASES = [_case(f"{m}-{b:g}", m, b) for m in MODES for b in BANDS]
CASES = {c["name"]: c for c in MODE_CASES + [
    # remat through K1's wrapper (its calls counted; JAX's lowrank computes the same values)
    _case("remat", "lowrank", 1e-4, port_mode="kernel", remat=True, meshes=("2x2", "2x1x2")),
    _case("mb2-remat", "lowrank", 1e-4, port_mode="kernel", microbatch=2, remat=True,
          meshes=("2x2",)),
    _case("fused-float", "float", 1e-4, fused=True, meshes=("2x2",)),
    _case("fused-lowrank", "lowrank", 1e-4, fused=True, meshes=("2x2",)),
    _case("compression", "float", 0.0, compression=True, opt=SGD, meshes=("2x1x2",)),
]}
UNFUSED = {"fused-float": "float-0.0001", "fused-lowrank": "lowrank-0.0001"}
MOE = family_case("moe", "moe", "exact_quant")     # tests/test_torch_dp_moe.py's case
MOE_SHAPE = "2x2x1"


def _cfg(c):
    return dataclasses.replace(
        reduced_config(get_config(ARCH)), remat=c["remat"], fuse_qkv=c["fused"],
        fuse_gate_up=c["fused"],
        approx=ApproxConfig(multiplier="mul8x8_2", mode=c["port_mode"], band_reg=c["band"]))


def _jax_cfg(c):
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.core.approx import ApproxConfig as JApprox

    return dataclasses.replace(jreduced(jget(ARCH)), approx=JApprox(
        multiplier="mul8x8_2", mode=c["mode"], band_reg=c["band"]))


def _batch(seed=0):
    from repro_torch.data.synthetic import token_batches

    return next(token_batches(reduced_config(get_config(ARCH)).vocab_size, BATCH, SEQ,
                              seed=seed))


def _sizes(spec):
    s = parse_mesh(spec, 1).shape
    return {"dp": s.get("data", 1), "tp": s.get("model", 1), "pod": s.get("pod", 1)}


def _np_tree(tree):
    return [t.detach().cpu().numpy() for t in leaves(tree)]


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------


class _K1Shapes:
    """K1's calls (the kernel wrapper as ``quantized_matmul`` reaches it)
    and their (M, K, N) while installed."""

    def __init__(self):
        import repro_torch.core.approx as A

        self.shapes, self._a, self._k1 = [], A, A.approx_matmul

        def k1(a, b, *args, **kw):
            self.shapes.append((a.shape[0], *b.shape))
            return self._k1(a, b, *args, **kw)

        A.approx_matmul = k1

    def close(self):
        self._a.approx_matmul = self._k1


def _step(c, init, mesh, batch):
    """One step of case ``c`` from the JAX initial state on this rank:
    (its report, the rank's new state); rank 0 adds the whole new state
    and the one-device step's moments from the same state and batch."""
    cfg, opt = _cfg(c), O.OptConfig(**c["opt"])
    state = fsdp.shard_state(state_from_numpy(init), cfg, mesh)
    bytes0 = tree_bytes(state)
    step = loop.make_train_step(cfg, opt, microbatch=c["microbatch"],
                                grad_compression=c["compression"], mesh=mesh)
    k1, calls = _K1Shapes(), COUNTS["calls"]
    try:
        state, m = step(state, loop.as_batch(batch, "cpu"))
    finally:
        k1.close()
    rep = {"metrics": {k: v.item() for k, v in m.items()}, "collectives": COUNTS["calls"] - calls,
           "k1": len(k1.shapes), "k1_shapes": sorted(set(k1.shapes)), "bytes": bytes0,
           "bytes_after": tree_bytes(state)}
    whole = fsdp.whole_state(state, cfg, mesh, device="cpu")
    if mesh.rank == 0:
        rep["whole"] = {"params": _np_tree(whole["params"]),
                        **{k: _np_tree(whole["opt"][k]) for k in ("m", "v") if k in whole["opt"]}}
        one, _ = loop.make_train_step(cfg, opt, microbatch=c["microbatch"],
                                      grad_compression=c["compression"])(
            state_from_numpy(init), loop.as_batch(batch, "cpu"))
        rep["one_device"] = {k: _np_tree(one["opt"][k]) for k in ("m", "v") if k in one["opt"]}
    return rep, state


def _preemption(mesh):
    """The last rank takes a SIGTERM; before it no rank's poll stops, after
    it every rank's does."""
    with PreemptionGuard(mesh=mesh) as guard:
        before = guard.poll()
        if mesh.rank == mesh.size - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"before": before, "after": guard.poll(), "local": guard.should_stop}


def _restored(init, mesh, ckpt_dir):
    """The 2x2 checkpoint restored on this mesh: the rank's parts."""
    cfg = _cfg(CASES[SAVED])
    target = fsdp.shard_state(state_from_numpy(init[SAVED]), cfg, mesh)
    part, at = ckpt.restore_checkpoint(ckpt_dir, target, cfg=cfg, mesh=mesh)
    return {"at": at, "opt_step": int(part["opt"]["step"]),
            **{k: _np_tree(t) for k, t in (("params", part["params"]), ("m", part["opt"]["m"]),
                                           ("v", part["opt"]["v"]))}}


def _mesh_job(spec, mesh, init):
    rep = {"cases": {}}
    batch = _batch()
    for name, c in CASES.items():
        if spec in c["meshes"]:
            rep["cases"][name], state = _step(c, init["state"][name], mesh, batch)
            if spec == SAVED_AT and name == SAVED:
                ckpt.save_checkpoint(init["ckpt_dir"], 1, state, cfg=_cfg(c), mesh=mesh)
    if spec == SAVED_AT:
        rep["preemption"] = _preemption(mesh)
    if spec == "2x1x2":
        rep["restored"] = _restored(init["state"], mesh, init["ckpt_dir"])
    if spec == MOE_SHAPE:
        log = RouteLog()
        try:
            log.take()
            rep["moe"], _ = step_case(MOE, init["moe"], init["moe_batch"], mesh, on_rank=log.take)
        finally:
            log.close()
    return rep


def _rank_job(rank, world, store_path, init_path):
    """Every mesh of ``SHAPES`` (and a data axis of 4, which restores the
    2x2 checkpoint) carved from one spawned world of 4 ranks, the groups
    made by every rank in one order; each rank runs the meshes it is in,
    the others wait at a barrier."""
    torch.set_num_threads(1)
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    world_mesh = DataMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                          backend="gloo", device="cpu")
    try:
        meshes = {spec: carve_mesh(parse_mesh(spec, 1), range(mesh_ranks(parse_mesh(spec, 1))),
                                   "cpu") for spec in SHAPES + ("4",)}
        out = {}
        for spec in SHAPES + ("4",):
            if meshes[spec] is not None:
                out[spec] = (_mesh_job(spec, meshes[spec], init) if spec != "4" else
                             {"restored": _restored(init["state"], meshes[spec],
                                                    init["ckpt_dir"])})
            dist.barrier(group=world_mesh.group)
        return out
    finally:
        world_mesh.close()


# ---------------------------------------------------------------------------
# fixtures: the JAX oracle and the world
# ---------------------------------------------------------------------------


def _oracle(init):
    """Case -> JAX's no-mesh step on the global batch: its metrics and new
    parameters and moments; and the moe case's step and routing."""
    import jax
    import jax.numpy as jnp

    from repro.train import loop as jloop
    from repro.train import optim as JO

    toks, labels = _batch()
    out = {}
    for name, c in CASES.items():
        if c["fused"]:
            continue
        step = jax.jit(jloop.make_train_step(_jax_cfg(c), JO.OptConfig(**c["opt"]),
                                             microbatch=c["microbatch"],
                                             grad_compression=c["compression"]))
        st, m = step(jax.tree.map(jnp.asarray, init["state"][name]),
                     {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": [np.asarray(x) for x in jax.tree.leaves(st["params"])],
                     **{k: [np.asarray(x) for x in jax.tree.leaves(st["opt"][k])]
                        for k in ("m", "v") if k in st["opt"]}}
    out["moe"] = {**jax_step(MOE, init["moe"], init["moe_batch"]),
                  "routing": jax_routing(MOE, init["moe"], init["moe_batch"])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.train import loop as jloop
    from repro.train import optim as JO

    base = tmp_path_factory.mktemp("tp_train")
    state = {name: jax.tree.map(np.asarray, jloop.init_state(
        _jax_cfg(c), JO.OptConfig(**c["opt"]), jax.random.PRNGKey(0),
        grad_compression=c["compression"])) for name, c in CASES.items()}
    init = {"state": state, "ckpt_dir": str(base / "ck"), "moe": jax_init({"moe": MOE})["moe"],
            "moe_batch": family_batch(port_cfg(MOE))}
    # the world runs in a thread while this process computes the oracle;
    # the ranks read ``init`` from a file (a large spawn argument would
    # hold each rank's start until the one before it had imported this
    # module)
    init_path = str(base / "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init, f)
    ranks, errors = [], []

    def spawn():
        try:
            ranks.extend(run_ranks(_rank_job, 4, (str(base / "store"), init_path),
                                   timeout=_WORLD_TIMEOUT))
        except BaseException as e:      # re-raised in the test process below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        oracle = _oracle(init)
    finally:
        thread.join()
    if errors:
        raise errors[0]
    worlds = {spec: [r[spec] for r in ranks if spec in r] for spec in SHAPES + ("4",)}
    return worlds, oracle, init


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


STEPS = [(spec, name) for name, c in CASES.items() for spec in c["meshes"]]
JAX_STEPS = [(spec, name) for spec, name in STEPS if not CASES[name]["fused"]]


def _oracle_of(runs, name):
    return runs[1][name]


# ---------------------------------------------------------------------------
# the meshes against JAX's no-mesh step and the one-device port step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,name", JAX_STEPS)
def test_loss_and_metrics_match_jax_global_step(worlds, runs, spec, name):
    """Every rank prints the global loss and metrics: JAX's to rtol 1e-5."""
    want = _oracle_of(runs, name)["metrics"]
    for rank, rep in enumerate(worlds[spec]):
        got = rep["cases"][name]["metrics"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), rank
        for k in ("ce", "band_reg", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-9), (rank, k)
        assert got == worlds[spec][0]["cases"][name]["metrics"], rank


@pytest.mark.parametrize("spec,name", JAX_STEPS)
def test_new_state_matches_jax_global_step(worlds, runs, spec, name):
    """The whole new moments and parameters (gathered over both axes)
    against JAX's (module text)."""
    c, want = CASES[name], _oracle_of(runs, name)
    got = worlds[spec][0]["cases"][name]["whole"]
    lr = want["metrics"]["lr"]
    if c["compression"]:             # SGD: each weight moves by lr x its int8-rounded gradient
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * lr)
        return
    tol = FLOAT_TOL if c["mode"] == "float" else QUANT_TOL
    for key in ("m", "v"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    for a, b, m in zip(got["params"], want["params"], want["m"]):
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()
        assert sure.any() and d[sure].max() <= 1e-3 * lr


@pytest.mark.parametrize("spec,name", STEPS)
def test_moments_match_the_one_device_port_step(worlds, spec, name):
    """The mesh step's new moments against the port's own step on one
    device from the same state and batch (module text); with gradient
    compression one int8 step of the leaf's scale."""
    c = CASES[name]
    got = worlds[spec][0]["cases"][name]
    tol = (MODEL_AXIS_TOL if c["mode"] != "float" and _sizes(spec)["tp"] > 1
           else ONE_DEVICE_TOL)
    for key in got["one_device"]:
        for a, b in zip(got["whole"][key], got["one_device"][key]):
            if c["compression"]:
                np.testing.assert_allclose(a, b, rtol=0, atol=1.01 * np.abs(b).max() / 127)
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("name", sorted(UNFUSED))
def test_fused_projections_match_the_unfused_step(worlds, name):
    """At 2x2 each rank's fused q/k/v and gate/up products are its own
    column parts joined (``[q_r | k_r | v_r]``): the step equals the
    unfused 2x2 step's loss to rtol 1e-6 and, in float, its moments to
    2**-9.  In a quantized mode the fused product rounds its input's
    summed cotangent to bf16 once, where the separate products round
    theirs apart: on one device too the two steps' moments part (by 0.0056
    of a leaf's largest in lowrank here), so the mesh's are held to
    2**-7."""
    got = worlds["2x2"][0]["cases"][name]
    want = worlds["2x2"][0]["cases"][UNFUSED[name]]
    tol = ONE_DEVICE_TOL if CASES[name]["mode"] == "float" else MODEL_AXIS_TOL
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=1e-6)
    for key in ("m", "v"):
        for a, b in zip(got["whole"][key], want["whole"][key]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,name", STEPS)
def test_collectives_k1_and_state_bytes_match_the_counts(worlds, spec, name):
    """Each rank's collectives in the step equal
    ``collectives_per_train_step`` at the mesh's sizes; K1's calls
    ``k1_per_train_step`` per microbatch through the wrapper (none in the
    other modes) at ``k1_shapes_per_rank``'s (M, K, N); the state bytes
    per rank ``state_bytes_per_rank``, before and after the step."""
    c, n = CASES[name], _sizes(spec)
    cfg = _cfg(c)
    want = collectives_per_train_step(cfg, n["dp"], tp=n["tp"], pod=n["pod"],
                                      microbatch=c["microbatch"], grad_compression=c["compression"])
    kernel = c["port_mode"] == "kernel"
    k1 = k1_per_train_step(cfg) * c["microbatch"] if kernel else 0
    shapes = k1_shapes_per_rank(cfg, BATCH * SEQ // c["microbatch"], n["dp"], tp=n["tp"],
                                pod=n["pod"]) if kernel else []
    state = state_bytes_per_rank(cfg, n["dp"], tp=n["tp"], pod=n["pod"], opt_kind=c["opt"]["kind"],
                                 grad_compression=c["compression"])
    for rank, rep in enumerate(worlds[spec]):
        got = rep["cases"][name]
        assert got["collectives"] == want, rank
        assert got["k1"] == k1 and got["k1_shapes"] == shapes, rank
        assert got["bytes"] == got["bytes_after"] == state, rank


@pytest.mark.parametrize("spec", SHAPES)
def test_every_projection_is_split_as_the_rules_say(spec):
    """Under a model axis every projection, the head and the 512-row
    embedding split over it (a column, row or vocab split) and over the
    data axis where it holds more than one rank; the norm scales stay
    whole."""
    cfg, n = _cfg(CASES["float-0"]), _sizes(spec)
    for (path, _, spec_), (d, m) in zip(fsdp.leaf_specs(cfg, parse_mesh(spec, 1)),
                                        fsdp.split_dims(cfg, parse_mesh(spec, 1))):
        if spec_ == ():
            assert "ln" in path or "norm" in path
            continue
        assert (d is not None) == (n["dp"] > 1), path
        want = None if n["tp"] == 1 else (-2 if path.endswith(("wo", "w_down", "['embed']"))
                                          else -1)
        assert m == want, path


# ---------------------------------------------------------------------------
# checkpoints, preemption, the moe on a pod axis
# ---------------------------------------------------------------------------


def _whole_of(init, ckpt_dir):
    whole, step = ckpt.restore_checkpoint(ckpt_dir, state_from_numpy(init[SAVED]))
    return whole, step


def test_2x2_checkpoint_restores_at_one_device(worlds, runs):
    whole, step = _whole_of(runs[2]["state"], runs[2]["ckpt_dir"])
    assert step == 1 and int(whole["opt"]["step"]) == 1
    saved = worlds[SAVED_AT][0]["cases"][SAVED]["whole"]
    for key, tree in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                      ("v", whole["opt"]["v"])):
        for a, b in zip(_np_tree(tree), saved[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["2x1x2", "4"])
def test_2x2_checkpoint_restores_at_another_mesh(worlds, runs, spec):
    """Each rank of 2x1x2 (a pod axis, no data split) and of a data axis of
    4 keeps its block of the whole leaves, bit for bit."""
    whole, _ = _whole_of(runs[2]["state"], runs[2]["ckpt_dir"])
    cfg = _cfg(CASES[SAVED])
    shape = parse_mesh(spec, 1)
    P, D, M = (shape.shape.get(a, 1) for a in ("pod", "data", "model"))
    dims = fsdp.split_dims(cfg, shape)
    for rank, rep in enumerate(worlds[spec]):
        got = rep["restored"]
        assert got["at"] == 1 and got["opt_step"] == 1
        _, d_rank, m_rank = np.unravel_index(rank, (P, D, M))
        for key, tree in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                          ("v", whole["opt"]["v"])):
            for part, full, (d, m) in zip(got[key], _np_tree(tree), dims):
                for dim, r, size in ((m, m_rank, M), (d, d_rank, D)):
                    if dim is not None:
                        n = full.shape[dim] // size
                        full = np.take(full, range(r * n, (r + 1) * n), axis=dim)
                np.testing.assert_array_equal(part, full)


def test_2x2_checkpoint_restores_into_jax(worlds, runs):
    import jax
    import jax.numpy as jnp

    from repro.train import checkpoint as jckpt

    jst, step = jckpt.restore_checkpoint(runs[2]["ckpt_dir"],
                                         jax.tree.map(jnp.asarray, runs[2]["state"][SAVED]))
    assert step == 1
    saved = worlds[SAVED_AT][0]["cases"][SAVED]["whole"]
    for key, tree in (("params", jst["params"]), ("m", jst["opt"]["m"]),
                      ("v", jst["opt"]["v"])):
        for a, b in zip(jax.tree.leaves(tree), saved[key]):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_preemption_stops_every_rank_at_the_same_step(worlds):
    reps = [r["preemption"] for r in worlds[SAVED_AT]]
    assert [r["before"] for r in reps] == [False] * 4
    assert [r["after"] for r in reps] == [True] * 4
    assert [r["local"] for r in reps] == [False, False, False, True]


def test_moe_on_a_pod_axis_matches_jax(worlds, runs):
    """The reduced qwen2-moe at 2x2x1: its batch over the 4 ranks of pod x
    data, every layer's kept assignments (the ranks' joined in rank order),
    dropped count and capacity equal to JAX's ``moe_ffn`` on the global
    batch, and the step to JAX's at ``tests/test_torch_dp_moe.py``'s
    tolerances."""
    from test_torch_train_families import QUANTIZED

    reps = [r["moe"] for r in worlds[MOE_SHAPE]]
    want = runs[1]["moe"]
    routing = want["routing"]
    assert len(routing) == len(reps[0]["record"]) == port_cfg(MOE).num_layers
    for layer, w in enumerate(routing):
        np.testing.assert_array_equal(
            np.concatenate([r["record"][layer]["keep"] for r in reps]), w["keep"])
        assert sum(r["record"][layer]["dropped"] for r in reps) == w["dropped"], layer
        assert {r["record"][layer]["capacity"] for r in reps} == {w["capacity"]}, layer
    mode, *tols = QUANTIZED["moe"]
    assert mode == MOE["mode"]
    check_against_jax(reps[0], want, want["metrics"]["lr"], *tols)
    for key in ("m", "v"):
        for a, b in zip(reps[0]["whole"][key], reps[0]["one_device"][key]):
            np.testing.assert_allclose(a, b, rtol=ONE_DEVICE_TOL,
                                       atol=ONE_DEVICE_TOL * np.abs(b).max())


# ---------------------------------------------------------------------------
# pieces without a process group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "qwen2-vl-2b", "musicgen-large"])
@pytest.mark.parametrize("spec", ["1x2", "2x2", "2x1x2"])
def test_model_axis_refused_for_other_families(arch, spec):
    """A model axis above 1 trains the dense family only: the others name
    item 17; their pod and data axes train."""
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="item 17"):
        loop.check_data_mesh(cfg, parse_mesh(spec, 1))
    loop.check_data_mesh(cfg, parse_mesh(spec.rsplit("x", 1)[0] + "x1", 1))


def test_heads_the_model_axis_does_not_divide_are_refused(tmp_path):
    """The reduced granite's 2 KV heads do not split over 4 model ranks:
    the step and the launcher (before any weight is built) raise
    ``TPHeadsError``, naming the sequence-parallel fallback's item 17."""
    from repro_torch.launch import train as launch

    cfg = reduced_config(get_config(ARCH))
    with pytest.raises(TPHeadsError, match="item 17"):
        loop.make_train_step(cfg, O.OptConfig(), mesh=parse_mesh("1x4", 1))
    with pytest.raises(TPHeadsError, match="item 17"):
        launch.main(["--reduced", "--device", "cpu", "--mesh", "1x4", "--steps", "1",
                     "--ckpt", str(tmp_path / "ck")])


def test_opt_state_pspecs_match_jax_on_a_pod_mesh(runs):
    """The moments mirror the parameters' 2-D and 3-D specs and the step
    replicates, as JAX's ``opt_state_shardings`` says, on a (2, 16, 16)
    pod x data x model mesh."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.parallel.sharding import param_shardings
    from repro.train import optim as JO

    name = "float-0"
    jcfg, cfg = _jax_cfg(CASES[name]), _cfg(CASES[name])
    amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    init = runs[2]["state"][name]
    jparams = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), init["params"])
    want = JO.opt_state_shardings(JO.OptConfig(), param_shardings(jcfg, jparams, amesh), amesh)
    params = state_from_numpy(init)["params"]
    got = opt_state_pspecs(O.OptConfig(), param_pspecs(cfg, params, MeshShape(
        (("pod", 2), ("data", 16), ("model", 16)))))
    assert sorted(got) == sorted(want) and got["step"] == tuple(want["step"].spec) == ()
    pad = lambda s, n: tuple(s) + (None,) * (n - len(s))
    for k in ("m", "v"):
        specs = [pad(s.spec, len(t.shape)) for s, t in zip(jax.tree.leaves(want[k]),
                                                           leaves(params))]
        assert [pad(s, len(t.shape)) for s, t in zip(got[k].values(), leaves(params))] == specs


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_a_2x2_mesh_and_resumes_at_a_data_axis(tmp_path, capfd):
    """``--mesh 2x2`` for 2 steps, then ``--mesh 4`` resumes at step 2 from
    rank 0's whole checkpoint."""
    from repro_torch.launch import train as launch

    d = str(tmp_path / "ck")
    common = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt", d,
              "--ckpt-every", "1"]
    out = launch.main(common + ["--mesh", "2x2", "--steps", "2"])
    assert out["start"] == 0 and out["step"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all() and ckpt.latest_step(d) == 2
    out2 = launch.main(common + ["--mesh", "4", "--steps", "3"])
    assert out2["start"] == 2 and out2["step"] == 3 and len(out2["losses"]) == 1
    text = capfd.readouterr().out           # the ranks print from their own processes
    assert "on mesh 2x2 (data x model, 4 ranks)" in text
    assert "resumed at step 2" in text and "x 4 data ranks" in text

"""Data-parallel training with FSDP sharding (``make_train_step(...,
mesh=DataMesh)``, ``launch/train.py --mesh``) against the JAX package's
no-mesh ``make_train_step`` on the whole global batch, on the CPU over
gloo.

The model is ``reduced_config(granite-3-2b)`` (2 layers, d 128, 4/2 heads
of 32, d_ff 256, vocab 512, float32) with the JAX package's seeded
weights carried across by ``bridge.state_from_numpy``; batches of 12 rows
of 16 tokens.  At dp 2 and 4 every projection, the embedding and the head
live on each rank as their 1/dp (the ``"fsdp"`` rules split d = 128); at
dp 3 nothing divides, every leaf is replicated, and only the activation
ranges' MAX and the gradients' all-reduce act.  Modes ``float``,
``exact_quant`` and ``lowrank``, with the band regularizer on and off.

Tolerances (each rank's step against JAX's on the global batch):

* the loss and every metric: rtol 1e-5 (float32 summation order: the
  ranks' mean of their local CE);
* the new moments: float 1e-3 of each leaf's largest, as one device's
  step (``tests/test_torch_train.py``); the quantized modes 2**-6 of it,
  the tightest power of two every seed-0 step here passes: the port's
  own step on one device is as far from JAX's at this batch (exact_quant
  0.0118 of a leaf's largest, lowrank 0.0075: the straight-through
  product rounds its weight cotangents to bf16, and a float32 sum that
  differs in its last bit rounds to the neighbouring bf16 value); against
  that one-device port step the mesh step's moments hold to 2**-9, split
  or replicated (the ranks' float32 partial weight gradients of each use
  are summed before the one rounding, ``core.approx.approx_dense``, a
  split weight's by its gather's reduce-scatter, a replicated one's by an
  all-reduce);
* the new parameters: AdamW's first step moves each weight by lr times
  about the sign of its gradient, so no weight may differ by more than
  2.1 lr, and a weight whose moment is certain (above twice the moments'
  tolerance) by no more than 1e-3 lr.

Beside that: ``microbatch`` 2 with ``remat`` (rank r's microbatch j is the
r-th slice of JAX's chunk j), gradient compression against JAX's
compressed step, one rank under the mesh path bit-equal to the no-mesh
step, ``opt_state_pspecs`` against JAX's ``opt_state_shardings``, the
collectives and K1 calls per step against ``collectives_per_train_step``
and ``k1_per_train_step``, the state bytes per rank, a checkpoint written
at dp 2 restored at dp 1, at dp 4 and into the JAX package, the
preemption flag agreed by every rank, the launcher at ``--mesh 2`` then
``--mesh 4`` resuming, and the refusals.

One world of 4 ranks is spawned once per module (``launch.mesh.run_ranks``,
a ``FileStore`` under a temporary directory); dp d runs every case of its
size on the subgroup of the first d ranks, and the tests read the
reports.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.data.synthetic import token_batches
from repro_torch.launch.dryrun import collectives_per_train_step, k1_per_train_step
from repro_torch.launch.mesh import DataMesh, MeshShape, mesh_ranks, parse_mesh, run_ranks
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import COUNTS
from repro_torch.parallel.sharding import opt_state_pspecs, param_pspecs, tree_bytes
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.fault import PreemptionGuard
from repro_torch.train.tree import leaves

ARCH = "granite-3-2b"
BATCH, SEQ = 12, 16
_WORLD_TIMEOUT = 150
MODES = ("float", "exact_quant", "lowrank")
BANDS = (0.0, 1e-4)
QUANT_TOL = 2.0 ** -6
FLOAT_TOL = 1e-3
ONE_DEVICE_TOL = {2: 2.0 ** -9, 3: 2.0 ** -9, 4: 2.0 ** -9}   # by dp: see the module text
ADAMW = dict(kind="adamw", lr=1e-3, warmup_steps=0, total_steps=10)
SGD = dict(kind="sgd", lr=1e-2, warmup_steps=0, total_steps=10)


def _case(name, mode, band, *, port_mode=None, microbatch=1, remat=False,
          compression=False, opt=ADAMW):
    return {"name": name, "mode": mode, "port_mode": port_mode or mode, "band": band,
            "microbatch": microbatch, "remat": remat, "compression": compression, "opt": opt}


MODE_CASES = [_case(f"{m}-{b:g}", m, b) for m in MODES for b in BANDS]
# remat through K1's wrapper (its calls counted; JAX's lowrank computes the same values)
REMAT = _case("remat", "lowrank", 1e-4, port_mode="kernel", remat=True)
MB_REMAT = _case("mb2-remat", "lowrank", 1e-4, port_mode="kernel", microbatch=2, remat=True)
COMPRESSION = _case("compression", "float", 0.0, compression=True, opt=SGD)
CASES = {c["name"]: c for c in MODE_CASES + [REMAT, MB_REMAT, COMPRESSION]}
WORLDS = {2: [c["name"] for c in MODE_CASES] + ["mb2-remat", "compression"],
          3: [c["name"] for c in MODE_CASES],
          4: [c["name"] for c in MODE_CASES] + ["remat"]}
SAVED_CASE = "lowrank-0.0001"              # the dp=2 world checkpoints this case's state


def _cfg(case):
    return dataclasses.replace(
        reduced_config(get_config(ARCH)), remat=case["remat"],
        approx=ApproxConfig(multiplier="mul8x8_2", mode=case["port_mode"], band_reg=case["band"]))


def _batch():
    return next(token_batches(reduced_config(get_config(ARCH)).vocab_size, BATCH, SEQ, seed=0))


def _np_tree(tree):
    return [t.detach().cpu().numpy() for t in leaves(tree)]


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------


class _K1Calls:
    """K1's calls (the kernel wrapper as ``quantized_matmul`` reaches it)
    while installed."""

    def __init__(self):
        import repro_torch.core.approx as A

        self.n, self._a, self._k1 = 0, A, A.approx_matmul

        def k1(*a, **kw):
            self.n += 1
            return self._k1(*a, **kw)

        A.approx_matmul = k1

    def close(self):
        self._a.approx_matmul = self._k1


def _step(case, init, mesh):
    """One step of ``case`` from the JAX initial state ``init`` on this
    rank: (metrics, collectives, K1 calls, state bytes, the new whole
    state on rank 0, the rank's new state)."""
    cfg = _cfg(case)
    opt = O.OptConfig(**case["opt"])
    state = fsdp.shard_state(state_from_numpy(init[case["name"]]), cfg, mesh)
    bytes0 = tree_bytes(state)
    step = loop.make_train_step(cfg, opt, microbatch=case["microbatch"],
                                grad_compression=case["compression"], mesh=mesh)
    batch = loop.as_batch(_batch(), "cpu")
    k1, calls = _K1Calls(), COUNTS["calls"]
    try:
        state, m = step(state, batch)
    finally:
        k1.close()
    rep = {"metrics": {k: v.item() for k, v in m.items()}, "collectives": COUNTS["calls"] - calls,
           "k1": k1.n, "bytes": bytes0, "bytes_after": tree_bytes(state)}
    whole = fsdp.whole_state(state, cfg, mesh, device="cpu")
    if mesh.rank == 0:
        rep["whole"] = {"params": _np_tree(whole["params"]),
                        **{k: _np_tree(whole["opt"][k]) for k in ("m", "v") if k in whole["opt"]}}
        one, _ = loop.make_train_step(cfg, opt, microbatch=case["microbatch"],
                                      grad_compression=case["compression"])(
            state_from_numpy(init[case["name"]]), batch)
        rep["one_device"] = {k: _np_tree(one["opt"][k]) for k in ("m", "v") if k in one["opt"]}
    return rep, state


def _preemption(mesh):
    """Rank 1 takes a SIGTERM; before it no rank's poll stops, after it
    every rank's does."""
    with PreemptionGuard(mesh=mesh) as guard:
        before = guard.poll()
        if mesh.rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"before": before, "after": guard.poll(), "local": guard.should_stop}


class _SubMesh:
    """A data mesh over a subgroup of the spawned world's ranks (its first
    ``size``), as the port reads a mesh: the group, this rank's index, the
    axis size and the device."""

    axis_names = ("data",)
    device = torch.device("cpu")

    def __init__(self, group, rank, size):
        self.group, self.rank, self.size, self.shape = group, rank, size, {"data": size}


def _rank_job(rank, world, store_path, init_path, ckpt_dir):
    """Every case of every dp on one spawned world of ``max(WORLDS)``
    ranks: dp d runs on the subgroup of its first d ranks (the others wait
    at a barrier), dp 2 before dp 4, which restores its checkpoint.  One
    world, where a world per dp would start 10 processes."""
    import pickle

    torch.set_num_threads(1)
    with open(init_path, "rb") as f:          # written by this module's fixture
        init = pickle.load(f)
    mesh = DataMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                    backend="gloo", device="cpu")
    try:
        groups = {dp: dist.new_group(list(range(dp))) for dp in (1, 2, 3)}
        groups[world] = mesh.group
        out = {}
        for dp in (1, 2, 3, 4):
            if rank < dp:
                out[dp] = _dp_job(_SubMesh(groups[dp], rank, dp), init, ckpt_dir)
            dist.barrier(group=mesh.group)
        return out
    finally:
        mesh.close()


def _dp_job(mesh, init, ckpt_dir):
    """This rank's report of every case of ``mesh.size`` data ranks."""
    dp = mesh.size
    if dp == 1:
        return {"cases": {}, "one_rank": _one_rank(init, mesh)}
    rep = {"cases": {}}
    for name in WORLDS[dp]:
        rep["cases"][name], state = _step(CASES[name], init, mesh)
        if dp == 2 and name == SAVED_CASE:
            ckpt.save_checkpoint(ckpt_dir, 1, state, cfg=_cfg(CASES[name]), mesh=mesh)
    if dp == 2:
        rep["preemption"] = _preemption(mesh)
    if dp == 4:                  # the dp=2 checkpoint, restored at dp=4
        cfg = _cfg(CASES[SAVED_CASE])
        target = fsdp.shard_state(state_from_numpy(init[SAVED_CASE]), cfg, mesh)
        part, step = ckpt.restore_checkpoint(ckpt_dir, target, cfg=cfg, mesh=mesh)
        rep["restored"] = {"step": step, "params": _np_tree(part["params"]),
                           "m": _np_tree(part["opt"]["m"]), "v": _np_tree(part["opt"]["v"]),
                           "opt_step": int(part["opt"]["step"])}
    return rep


def _one_rank(init, mesh):
    """The mesh path on one rank against the no-mesh step from the same
    state and batch: bit-equal loss, metrics, parameters and moments."""
    out = {}
    for name in ("lowrank-0.0001", "mb2-remat", "compression"):
        case = CASES[name]
        cfg, opt = _cfg(case), O.OptConfig(**case["opt"])
        batch = loop.as_batch(_batch(), "cpu")
        kw = dict(microbatch=case["microbatch"], grad_compression=case["compression"])
        a, ma = loop.make_train_step(cfg, opt, mesh=mesh, **kw)(
            fsdp.shard_state(state_from_numpy(init[name]), cfg, mesh), batch)
        b, mb = loop.make_train_step(cfg, opt, **kw)(state_from_numpy(init[name]), batch)
        out[name] = {"metrics": all(torch.equal(ma[k], mb[k]) for k in mb),
                     "state": all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))}
    return out


# ---------------------------------------------------------------------------
# fixtures: the JAX oracle and the worlds
# ---------------------------------------------------------------------------


def _oracle_key(name):
    """The case whose JAX step is ``name``'s oracle: remat changes no
    value, so the remat case's is the same step without it."""
    return "lowrank-0.0001" if name == "remat" else name


def _jax_cfgs(case):
    """The JAX config of ``case`` (never remat: it changes no value)."""
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.core.approx import ApproxConfig as JApprox

    return dataclasses.replace(jreduced(jget(ARCH)),
                               approx=JApprox(multiplier="mul8x8_2", mode=case["mode"],
                                              band_reg=case["band"]))


@pytest.fixture(scope="module")
def init():
    """Case -> the JAX package's seeded initial training state (numpy)."""
    import jax

    from repro.train import loop as jloop
    from repro.train import optim as JO

    return {name: jax.tree.map(np.asarray, jloop.init_state(
        _jax_cfgs(c), JO.OptConfig(**c["opt"]), jax.random.PRNGKey(0),
        grad_compression=c["compression"])) for name, c in CASES.items()}


def _jax_oracle(init):
    """Oracle key -> JAX's no-mesh step on the global batch: its metrics
    and new parameters and moments."""
    import jax
    import jax.numpy as jnp

    from repro.train import loop as jloop
    from repro.train import optim as JO

    toks, labels = _batch()
    out = {}
    for name, c in CASES.items():
        if _oracle_key(name) != name:
            continue
        step = jax.jit(jloop.make_train_step(_jax_cfgs(c), JO.OptConfig(**c["opt"]),
                                             microbatch=c["microbatch"],
                                             grad_compression=c["compression"]))
        st, m = step(jax.tree.map(jnp.asarray, init[name]),
                     {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": [np.asarray(x) for x in jax.tree.leaves(st["params"])],
                     **{k: [np.asarray(x) for x in jax.tree.leaves(st["opt"][k])]
                        for k in ("m", "v") if k in st["opt"]}}
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dp_ckpt") / "ck")


@pytest.fixture(scope="module")
def runs(init, ckpt_dir, tmp_path_factory):
    """(dp -> each of its ranks' reports, the JAX oracle): the world runs
    in a thread while this process computes the oracle.  The ranks read
    the initial states from a file: a large argument would hold each
    rank's start until the one before it had imported this module."""
    import pickle
    import threading

    base = tmp_path_factory.mktemp("dp_worlds")
    init_path = str(base / "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init, f)
    ranks, errors = [], []

    def spawn():
        try:
            ranks.extend(run_ranks(_rank_job, max(WORLDS), (str(base / "store"), init_path,
                                                             ckpt_dir), timeout=_WORLD_TIMEOUT))
        except BaseException as e:      # re-raised in the test process below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        oracle = _jax_oracle(init)
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return {dp: [r[dp] for r in ranks[:dp]] for dp in (1, 2, 3, 4)}, oracle


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_oracle(runs):
    return {name: runs[1][_oracle_key(name)] for name in CASES}


def _cases_of(dp):
    return [(dp, name) for name in WORLDS[dp]]


ALL = _cases_of(2) + _cases_of(3) + _cases_of(4)


# ---------------------------------------------------------------------------
# the worlds against JAX's no-mesh step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,name", ALL)
def test_loss_and_metrics_match_jax_global_step(worlds, jax_oracle, dp, name):
    """Every rank prints the global loss and metrics: JAX's to rtol 1e-5."""
    want = jax_oracle[name]["metrics"]
    for rank, rep in enumerate(worlds[dp]):
        got = rep["cases"][name]["metrics"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), rank
        for k in ("ce", "band_reg", "grad_norm", "lr"):
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-9), (rank, k)
        assert got == worlds[dp][0]["cases"][name]["metrics"], rank


@pytest.mark.parametrize("dp,name", ALL)
def test_new_state_matches_jax_global_step(worlds, jax_oracle, dp, name):
    """The whole new moments and parameters (gathered from the ranks'
    parts) against JAX's (module text)."""
    case, want, got = CASES[name], jax_oracle[name], worlds[dp][0]["cases"][name]["whole"]
    if case["compression"]:          # SGD: each weight moves by lr x its int8-rounded gradient
        lr = want["metrics"]["lr"]
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-2 * lr)
        return
    tol = FLOAT_TOL if case["mode"] == "float" else QUANT_TOL
    for key in ("m", "v"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    lr = want["metrics"]["lr"]
    for a, b, m in zip(got["params"], want["params"], want["m"]):
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()
        assert sure.any() and d[sure].max() <= 1e-3 * lr


@pytest.mark.parametrize("dp,name", ALL)
def test_moments_match_the_one_device_port_step(worlds, dp, name):
    """The mesh step's new moments against the port's own step on one
    device from the same state and batch: within 2**-9 of each leaf's
    largest, at dp 3 too, where every weight is replicated (each use's
    weight gradient summed over the ranks in float32, then rounded to
    bf16 once).  With gradient compression (SGD: the moment
    is the int8-rounded gradient) one int8 step of the leaf's scale: a
    float32 gap can carry a gradient across a rounding boundary."""
    got = worlds[dp][0]["cases"][name]
    tol = ONE_DEVICE_TOL[dp]
    for key in got["one_device"]:
        for a, b in zip(got["whole"][key], got["one_device"][key]):
            if CASES[name]["compression"]:
                np.testing.assert_allclose(a, b, rtol=0, atol=1.01 * np.abs(b).max() / 127)
            else:
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("name", ["lowrank-0.0001", "mb2-remat", "compression"])
def test_one_rank_mesh_step_is_bit_equal_to_no_mesh(worlds, name):
    assert worlds[1][0]["one_rank"][name] == {"metrics": True, "state": True}


@pytest.mark.parametrize("dp,name", ALL)
def test_collectives_and_k1_per_step_match_the_counts(worlds, dp, name):
    """Each rank's collectives in the step equal
    ``collectives_per_train_step`` (remat on in "remat" and "mb2-remat",
    off elsewhere); K1's calls through the wrapper ``k1_per_train_step``
    per microbatch (remat on), none in the other modes."""
    case = CASES[name]
    cfg = _cfg(case)
    want = collectives_per_train_step(cfg, dp, microbatch=case["microbatch"],
                                      grad_compression=case["compression"])
    k1 = k1_per_train_step(cfg) * case["microbatch"] if case["port_mode"] == "kernel" else 0
    for rank, rep in enumerate(worlds[dp]):
        assert rep["cases"][name]["collectives"] == want, rank
        assert rep["cases"][name]["k1"] == k1, rank


@pytest.mark.parametrize("dp,name", ALL)
def test_state_bytes_per_rank(worlds, dp, name):
    """A rank holds 1/dp of every split leaf (parameter, moments, error
    buffer) and every replicated leaf whole, exactly."""
    case = CASES[name]
    cfg = _cfg(case)
    # the parameter, its moments and its error buffer
    per_leaf = 1 + (2 if case["opt"]["kind"] == "adamw" else 1) + case["compression"]
    whole = 0
    for (_, shape, spec), dim in zip(fsdp.leaf_specs(cfg, dp), fsdp.data_dims(cfg, dp)):
        n = int(np.prod(shape)) * 4
        whole += per_leaf * (n // dp if dim is not None else n)
    for rep in worlds[dp]:
        got = rep["cases"][name]
        assert got["bytes"] == got["bytes_after"] == whole + 4      # + the int32 step
    if dp == 3:
        assert all(d is None for d in fsdp.data_dims(cfg, dp))
    else:
        assert all(d is not None for (p, _, s), d in zip(fsdp.leaf_specs(cfg, dp),
                                                       fsdp.data_dims(cfg, dp)) if s != ())


def test_preemption_stops_every_rank_at_the_same_step(worlds):
    reps = [r["preemption"] for r in worlds[2]]
    assert [r["before"] for r in reps] == [False, False]
    assert [r["after"] for r in reps] == [True, True]
    assert [r["local"] for r in reps] == [False, True]


# ---------------------------------------------------------------------------
# checkpoints: written at dp 2, restored at dp 1, dp 4 and into JAX
# ---------------------------------------------------------------------------


def test_dp2_checkpoint_restores_at_dp1_and_dp4(worlds, init, ckpt_dir):
    cfg = _cfg(CASES[SAVED_CASE])
    target = state_from_numpy(init[SAVED_CASE])
    whole, step = ckpt.restore_checkpoint(ckpt_dir, target)
    assert step == 1 and int(whole["opt"]["step"]) == 1
    saved = worlds[2][0]["cases"][SAVED_CASE]["whole"]
    for key, tree in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                      ("v", whole["opt"]["v"])):
        for a, b in zip(_np_tree(tree), saved[key]):
            np.testing.assert_array_equal(a, b)
    dims = fsdp.data_dims(cfg, 4)
    for rank, rep in enumerate(worlds[4]):
        got = rep["restored"]
        assert got["step"] == 1 and got["opt_step"] == 1
        for key, tree in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                          ("v", whole["opt"]["v"])):
            for part, full, dim in zip(got[key], _np_tree(tree), dims):
                if dim is not None:
                    n = full.shape[dim] // 4
                    full = np.take(full, range(rank * n, (rank + 1) * n), axis=dim)
                np.testing.assert_array_equal(part, full)


def test_dp2_checkpoint_restores_into_jax(worlds, init, ckpt_dir):
    import jax
    import jax.numpy as jnp

    from repro.train import checkpoint as jckpt

    jst, step = jckpt.restore_checkpoint(ckpt_dir, jax.tree.map(jnp.asarray, init[SAVED_CASE]))
    assert step == 1
    saved = worlds[2][0]["cases"][SAVED_CASE]["whole"]
    for key, tree in (("params", jst["params"]), ("m", jst["opt"]["m"]),
                      ("v", jst["opt"]["v"])):
        for a, b in zip(jax.tree.leaves(tree), saved[key]):
            np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# pieces without a process group
# ---------------------------------------------------------------------------


class _Mesh:
    """One rank of a data axis, as the cuts read it."""

    axis_names = ("data",)

    def __init__(self, rank, size):
        self.rank, self.size, self.shape = rank, size, {"data": size}


@pytest.mark.parametrize("dp,microbatch", [(2, 1), (2, 2), (3, 2), (4, 1)])
def test_rank_rows_take_each_rank_its_slice_of_every_microbatch(dp, microbatch):
    cfg = _cfg(CASES["float-0"])
    batch = {"tokens": torch.arange(BATCH)[:, None].expand(BATCH, SEQ),
             "labels": torch.arange(BATCH)[:, None] + 100}
    size = BATCH // microbatch
    for r in range(dp):
        got = fsdp.rank_rows(batch, cfg, _Mesh(r, dp), microbatch)
        want = [j * size + r * (size // dp) + i for j in range(microbatch)
                for i in range(size // dp)]
        assert got["tokens"][:, 0].tolist() == want
        assert got["labels"][:, 0].tolist() == [w + 100 for w in want]
    with pytest.raises(ValueError, match="does not split"):
        fsdp.rank_rows(batch, cfg, _Mesh(0, 5), 1)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_opt_state_pspecs_match_jax(init, kind):
    """The moments mirror the parameters' specs and the step replicates,
    as JAX's ``opt_state_shardings`` says, on a (16, 16) mesh."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.parallel.sharding import param_shardings
    from repro.train import optim as JO

    name = "float-0" if kind == "adamw" else "compression"
    jcfg, cfg = _jax_cfgs(CASES[name]), _cfg(CASES[name])
    amesh = AbstractMesh((16, 16), ("data", "model"))
    jparams = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), init[name]["params"])
    want = JO.opt_state_shardings(JO.OptConfig(kind=kind), param_shardings(jcfg, jparams, amesh),
                                  amesh)
    params = state_from_numpy(init[name])["params"]
    got = opt_state_pspecs(O.OptConfig(kind=kind),
                           param_pspecs(cfg, params, MeshShape((("data", 16), ("model", 16)))))
    assert sorted(got) == sorted(want)
    assert got["step"] == tuple(want["step"].spec) == ()
    pad = lambda s, n: tuple(s) + (None,) * (n - len(s))
    for k in got:
        if k == "step":
            continue
        specs = [pad(s.spec, len(t.shape)) for s, t in zip(jax.tree.leaves(want[k]),
                                                           leaves(params))]
        assert [pad(s, len(t.shape)) for s, t in zip(got[k].values(), leaves(params))] == specs


@pytest.mark.parametrize("spec,devices,want", [("auto", 3, 3), ("2", 8, 2), ("4x1", 1, 4),
                                               ("1", 1, 1)])
def test_parse_mesh_data_ranks(spec, devices, want):
    assert mesh_ranks(parse_mesh(spec, devices)) == want


@pytest.mark.parametrize("spec,ranks", [("2x2", 4), ("1x4", 4), ("2x2x1", 4), ("1x1x1", 1)])
def test_model_and_pod_axes_are_refused(spec, ranks):
    """Items 9 and 10 are closed: a model axis and a pod axis train
    (``tests/test_torch_tp_train.py``), on ``parse_mesh``'s pod x data x
    model ranks; a mesh of one rank trains on one device."""
    shape = parse_mesh(spec, 1)
    assert mesh_ranks(shape) == ranks
    assert shape.axis_names == (("pod",) if spec.count("x") == 2 else ()) + ("data", "model")


@pytest.mark.parametrize("spec", ["x2", "2x", "0", "2x2x2x2", "two"])
def test_parse_mesh_rejects_malformed(spec):
    with pytest.raises(ValueError):
        parse_mesh(spec, 1)


@pytest.mark.parametrize("arch,item", [("qwen2-moe-a2.7b", "item 8"), ("falcon-mamba-7b", "item 7"),
                                       ("zamba2-2.7b", "item 7")])
def test_families_are_refused_under_a_data_mesh(arch, item, tmp_path):
    """Items 7 and 8 are closed: no family is refused on a data axis
    (``tests/test_torch_dp_families.py`` and ``test_torch_dp_moe.py``
    train them), nor on a pod axis.  A model axis is refused for these
    families, naming item 17 and no longer the family's own ``item``, by
    the step and, before it builds any weights, by the launcher."""
    from repro_torch.launch import train as launch

    cfg = reduced_config(get_config(arch))
    loop.make_train_step(cfg, O.OptConfig(), mesh=_Mesh(0, 2))
    loop.check_data_mesh(cfg, parse_mesh("2x2x1", 1))

    class _ModelAxis(_Mesh):
        axis_names = ("data", "model")

        def __init__(self, rank, size):
            super().__init__(rank, size)
            self.shape = {"data": size, "model": 2}

    with pytest.raises(NotImplementedError, match="item 17") as refused:
        loop.make_train_step(cfg, O.OptConfig(), mesh=_ModelAxis(0, 2))
    assert item not in str(refused.value)
    with pytest.raises(NotImplementedError, match="item 17"):
        launch.main(["--arch", arch, "--reduced", "--device", "cpu", "--mesh", "1x2",
                     "--steps", "1", "--ckpt", str(tmp_path / "ck")])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_a_mesh_and_resumes_at_another(tmp_path, capfd):
    """``--mesh 2`` for 2 steps, then ``--mesh 4`` resumes at step 2 from
    rank 0's whole checkpoint; the checkpoint restores on one device."""
    from repro_torch.launch import train as launch

    d = str(tmp_path / "ck")
    common = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16", "--ckpt", d,
              "--ckpt-every", "1"]
    out = launch.main(common + ["--mesh", "2", "--steps", "2"])
    assert out["start"] == 0 and out["step"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all() and ckpt.latest_step(d) == 2
    out2 = launch.main(common + ["--mesh", "4", "--steps", "4"])
    assert out2["start"] == 2 and out2["step"] == 4 and len(out2["losses"]) == 2
    assert ckpt.latest_step(d) == 4
    text = capfd.readouterr().out           # the ranks print from their own processes
    assert "resumed at step 2" in text and "x 4 data ranks" in text
    one = launch.main(common + ["--mesh", "1", "--steps", "5"])
    assert one["start"] == 4 and int(one["state"]["opt"]["step"]) == 5

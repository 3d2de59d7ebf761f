"""Data-parallel training of the ssm, hybrid, vlm and audio families
(``make_train_step(..., mesh=DataMesh)``) against the JAX package's
no-mesh ``make_train_step`` on the whole global batch and against the
port's own one-device step, on the CPU over gloo.

Each family runs at ``reduced_config`` (falcon-mamba-7b and musicgen-large
2 layers, qwen2-vl-2b 2, zamba2-2.7b one group of 2 Mamba-2 layers and the
shared attention block) from the JAX package's seeded state, on
``tests/test_torch_train_families.py``'s batch of 4 rows of 16 (tokens, or
embeddings with a ``positions_thw`` grid for the vlm), at dp 2 and 4 (the
``"fsdp"`` rules split d = 128 and d_inner = 256; the Mamba blocks'
``dt_proj``, convolution and scan parameters stay whole on every rank and
each use sums its gradient over the ranks).  Each family's step runs in
its quantized mode with the band regularizer, and is held:

* to JAX's step on the global batch at that file's tolerances for the
  family (``QUANTIZED``: the loss, the metrics, the moments as a share of
  each leaf's largest, and the move of each weight whose gradient's sign
  is certain, the ssm's at 0.03 lr);
* to the port's step on one device from the same state at 2**-9 of each
  moment leaf's largest (``tests/test_torch_dp.py``'s one-device
  tolerance): each rank's float32 weight gradients are summed over the
  ranks before their one bf16 rounding.

Beside that: ``microbatch`` 2 with ``remat`` through K1's wrapper at dp 2
(the ssm, and the hybrid with two groups, where the shared block's two
uses each sum their gradient over the ranks) and ``remat`` at dp 4 (the
audio family) against the one-device step, the collectives and K1 calls per step against
``collectives_per_train_step`` and ``k1_per_train_step``, a one-rank mesh
step bit-equal to the no-mesh step, an ssm checkpoint written at dp 2
resumed bit for bit and restored at dp 4, and ``rank_rows`` cutting the
embeddings and the positions grid.

One world of 4 ranks is spawned once per module (``launch.mesh.run_ranks``,
a ``FileStore`` under a temporary directory); dp d runs every case of its
size on the subgroup of the first d ranks while this process computes the
JAX oracle in a thread, and the tests read the reports.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bridge import state_from_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.data.synthetic import token_batches
from repro_torch.launch.dryrun import (band_term_costs, collectives_per_train_step,
                                       gathered_bytes_per_train_step, k1_per_train_step)
from repro_torch.launch.mesh import DataMesh, run_ranks
from repro_torch.parallel import fsdp
from repro_torch.parallel.collectives import COUNTS
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train import optim as O
from repro_torch.train.tree import leaves

ARCHS = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b", "vlm": "qwen2-vl-2b",
         "audio": "musicgen-large"}
ARCH_OF = {**ARCHS, "moe": "qwen2-moe-a2.7b"}      # tests/test_torch_dp_moe.py's too
B, S = 4, 16                       # tests/test_torch_train_families.py's batch
WORLD = 4
_WORLD_TIMEOUT = 150
ONE_DEVICE_TOL = 2.0 ** -9
ADAMW = dict(kind="adamw", lr=1e-3, warmup_steps=0, total_steps=10)
# each family's quantized mode (tests/test_torch_train_families.py QUANTIZED)
MODES = {"ssm": "exact_quant", "hybrid": "exact_quant", "vlm": "lowrank",
         "audio": "exact_quant"}


def case(name, family, mode, *, port_mode=None, band=1e-4, microbatch=1, remat=False,
         groups=1, dps=(2, 4), jax=True, data="base"):
    """A step to run at each dp of ``dps`` (and on one rank): its JAX
    mode, the port's (``kernel``: K1's wrapper, whose calls are counted,
    against JAX's ``lowrank``), the band term, microbatches, remat, the
    hybrid's groups, whether JAX's step is its oracle, and its batch."""
    return {"name": name, "family": family, "mode": mode, "port_mode": port_mode or mode,
            "band": band, "microbatch": microbatch, "remat": remat, "groups": groups,
            "dps": dps, "jax": jax, "data": data}


CASES = {c["name"]: c for c in
         [case(f, f, MODES[f]) for f in ARCHS]
         + [case("ssm-mb2-remat", "ssm", "lowrank", port_mode="kernel", microbatch=2,
                 remat=True, dps=(2,), jax=False),
            case("audio-remat", "audio", "lowrank", port_mode="kernel", remat=True, dps=(4,),
                 jax=False),
            case("hybrid2-mb2-remat", "hybrid", "lowrank", port_mode="kernel", microbatch=2,
                 remat=True, groups=2, dps=(2,), jax=False)]}
ONE_RANK = ("ssm", "hybrid2-mb2-remat", "vlm")     # the one-rank mesh step's cases
RESUME = "ssm"                      # written at dp 2, resumed there, restored at dp 4


def port_cfg(c):
    arch = ARCH_OF[c["family"]]
    cfg = reduced_config(get_config(arch), remat=c["remat"])
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every * c["groups"])
    return dataclasses.replace(cfg, approx=ApproxConfig(
        multiplier="mul8x8_2", mode=c["port_mode"], band_reg=c["band"]))


def jax_cfg(c):
    """The JAX config of case ``c`` (never remat: it changes no value)."""
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.core.approx import ApproxConfig as JApprox

    cfg = jreduced(jget(ARCH_OF[c["family"]]))
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every * c["groups"])
    return dataclasses.replace(cfg, approx=JApprox(multiplier="mul8x8_2", mode=c["mode"],
                                                   band_reg=c["band"]))


def thw_grid(B_, S_):
    """``tests/test_torch_train_families.py``'s positions grid: 4 text
    tokens, an image of 3 x 4 patches, then text."""
    thw = np.zeros((3, S_), np.int32)
    thw[:, :4] = np.arange(4)
    h, w = np.divmod(np.arange(12), 4)
    thw[0, 4:16], thw[1, 4:16], thw[2, 4:16] = 4, 4 + h, 4 + w
    thw[:, 16:] = 8 + np.arange(S_ - 16)
    return np.broadcast_to(thw, (B_, 3, S_)).copy()


def batch_np(cfg, seed=0):
    """``tests/test_torch_train_families.py``'s batch for ``cfg`` as numpy:
    tokens, or embeddings (and the vlm's grid), with labels."""
    toks, labels = next(token_batches(cfg.vocab_size, B, S, seed=seed))
    if cfg.embed_input:
        return {"tokens": toks, "labels": labels}
    rng = np.random.default_rng(seed + 10)
    out = {"embeddings": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
           "labels": labels}
    if cfg.pos_embedding == "m_rope":
        out["positions_thw"] = thw_grid(B, S)
    return out


def np_tree(tree):
    return [t.detach().cpu().numpy() for t in leaves(tree)]


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------


class K1Calls:
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


def step_case(c, init, batch, mesh, on_rank=None):
    """One step of case ``c`` from the JAX initial state ``init`` on this
    rank: (its report, the rank's new state).  Rank 0 also reports the
    whole new state and the one-device step's moments from the same
    state and batch.  ``on_rank()`` returns a record of the rank's step
    (read after it) and, called with ``one=True``, of the one-device
    step."""
    cfg = port_cfg(c)
    opt = O.OptConfig(**ADAMW)
    state = fsdp.shard_state(state_from_numpy(init), cfg, mesh)
    step = loop.make_train_step(cfg, opt, microbatch=c["microbatch"], mesh=mesh)
    k1, calls = K1Calls(), COUNTS["calls"]
    try:
        state, m = step(state, torch_batch(batch))
    finally:
        k1.close()
    rep = {"metrics": {k: v.item() for k, v in m.items()}, "collectives": COUNTS["calls"] - calls,
           "k1": k1.n}
    if on_rank is not None:
        rep["record"] = on_rank()
    whole = fsdp.whole_state(state, cfg, mesh, device="cpu")
    if mesh.rank == 0:
        rep["whole"] = {"params": np_tree(whole["params"]),
                        **{k: np_tree(whole["opt"][k]) for k in ("m", "v")}}
        one, m1 = loop.make_train_step(cfg, opt, microbatch=c["microbatch"])(
            state_from_numpy(init), torch_batch(batch))
        rep["one_device"] = {"metrics": {k: v.item() for k, v in m1.items()},
                             **{k: np_tree(one["opt"][k]) for k in ("m", "v")}}
        if on_rank is not None:
            rep["one_device"]["record"] = on_rank(one=True)
    return rep, state


def one_rank(c, init, batch, mesh):
    """The mesh path on one rank against the no-mesh step from the same
    state and batch: bit-equal metrics and new state."""
    cfg = port_cfg(c)
    opt = O.OptConfig(**ADAMW)
    kw = dict(microbatch=c["microbatch"])
    a, ma = loop.make_train_step(cfg, opt, mesh=mesh, **kw)(
        fsdp.shard_state(state_from_numpy(init), cfg, mesh), torch_batch(batch))
    b, mb = loop.make_train_step(cfg, opt, **kw)(state_from_numpy(init), torch_batch(batch))
    return {"metrics": all(torch.equal(ma[k], mb[k]) for k in mb),
            "state": all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))}


def resume(c, init, batches, mesh, ckpt_dir):
    """Step 1 at this dp, a checkpoint, step 2; then the checkpoint
    restored (each rank keeps its part) and step 2 again: the ranks' new
    parts and metrics must be bit-equal to the run that went on."""
    cfg = port_cfg(c)
    opt = O.OptConfig(**ADAMW)
    step = loop.make_train_step(cfg, opt, mesh=mesh)
    state, _ = step(fsdp.shard_state(state_from_numpy(init), cfg, mesh), torch_batch(batches[0]))
    ckpt.save_checkpoint(ckpt_dir, 1, state, cfg=cfg, mesh=mesh)
    went_on, m = step(state, torch_batch(batches[1]))
    target = fsdp.shard_state(state_from_numpy(init), cfg, mesh)
    back, at = ckpt.restore_checkpoint(ckpt_dir, target, cfg=cfg, mesh=mesh)
    again, m2 = step(back, torch_batch(batches[1]))
    return {"at": at, "metrics": all(torch.equal(m[k], m2[k]) for k in m),
            "state": all(torch.equal(x, y) for x, y in zip(leaves(went_on), leaves(again))),
            "loss": m["loss"].item()}


def restored_parts(c, init, mesh, ckpt_dir):
    """The dp-2 checkpoint restored at this dp: the rank's parts."""
    cfg = port_cfg(c)
    target = fsdp.shard_state(state_from_numpy(init), cfg, mesh)
    part, at = ckpt.restore_checkpoint(ckpt_dir, target, cfg=cfg, mesh=mesh)
    return {"at": at, "params": np_tree(part["params"]), "m": np_tree(part["opt"]["m"]),
            "v": np_tree(part["opt"]["v"])}


class SubMesh:
    """A data mesh over a subgroup of the spawned world's ranks (its first
    ``size``), as the port reads a mesh."""

    axis_names = ("data",)
    device = torch.device("cpu")

    def __init__(self, group, rank, size):
        self.group, self.rank, self.size, self.shape = group, rank, size, {"data": size}


def world_job(rank, world, store_path, init_path, dp_job):
    """Every dp's cases on one spawned world: dp d on the subgroup of its
    first d ranks (the others wait at a barrier), in order 1, 2, 4."""
    import pickle

    torch.set_num_threads(1)
    with open(init_path, "rb") as f:
        init = pickle.load(f)
    mesh = DataMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                    backend="gloo", device="cpu")
    try:
        groups = {dp: dist.new_group(list(range(dp))) for dp in (1, 2)}
        groups[world] = mesh.group
        out = {}
        for dp in (1, 2, world):
            if rank < dp:
                out[dp] = dp_job(SubMesh(groups[dp], rank, dp), init)
            dist.barrier(group=mesh.group)
        return out
    finally:
        mesh.close()


def _dp_job(mesh, init):
    dp = mesh.size
    base, ckpt_dir = init["batch"], init["ckpt_dir"]
    if dp == 1:
        return {"one_rank": {n: one_rank(CASES[n], init["state"][n], base[CASES[n]["family"]],
                                         mesh) for n in ONE_RANK}}
    rep = {"cases": {}}
    for name, c in CASES.items():
        if dp in c["dps"]:
            rep["cases"][name], _ = step_case(c, init["state"][name], base[c["family"]], mesh)
    if dp == 2:
        rep["resume"] = resume(CASES[RESUME], init["state"][RESUME], init["resume_batches"],
                               mesh, ckpt_dir)
    else:
        rep["restored"] = restored_parts(CASES[RESUME], init["state"][RESUME], mesh, ckpt_dir)
    return rep


def _rank_job(rank, world, store_path, init_path):
    return world_job(rank, world, store_path, init_path, _dp_job)


# ---------------------------------------------------------------------------
# fixtures: the JAX oracle and the world
# ---------------------------------------------------------------------------


def jax_init(cases):
    """Case -> the JAX package's seeded initial training state (numpy)."""
    import jax

    from repro.train import loop as jloop
    from repro.train import optim as JO

    return {name: jax.tree.map(np.asarray, jloop.init_state(
        jax_cfg(c), JO.OptConfig(**ADAMW), jax.random.PRNGKey(0)))
        for name, c in cases.items()}


def jax_step(c, init, batch):
    """JAX's no-mesh step of ``c`` on the global batch: its metrics and new
    parameters and moments (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.train import loop as jloop
    from repro.train import optim as JO

    step = jax.jit(jloop.make_train_step(jax_cfg(c), JO.OptConfig(**ADAMW),
                                         microbatch=c["microbatch"]))
    st, m = step(jax.tree.map(jnp.asarray, init), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": [np.asarray(x) for x in jax.tree.leaves(st["params"])],
            **{k: [np.asarray(x) for x in jax.tree.leaves(st["opt"][k])] for k in ("m", "v")}}


def spawn_world(job, init, base, oracle_fn):
    """(dp -> each of its ranks' reports, the oracle): the world runs in a
    thread while this process computes ``oracle_fn()``.  The ranks read
    ``init`` from a file: a large argument would hold each rank's start
    until the one before it had imported this module."""
    import pickle
    import threading

    init_path = str(base / "init.pkl")
    with open(init_path, "wb") as f:
        pickle.dump(init, f)
    ranks, errors = [], []

    def spawn():
        try:
            ranks.extend(run_ranks(job, WORLD, (str(base / "store"), init_path),
                                   timeout=_WORLD_TIMEOUT))
        except BaseException as e:      # re-raised in the test process below
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        oracle = oracle_fn()
    finally:
        thread.join()
    if errors:
        raise errors[0]
    return {dp: [r[dp] for r in ranks[:dp]] for dp in (1, 2, WORLD)}, oracle


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_families")
    state = jax_init(CASES)
    batch = {f: batch_np(port_cfg(CASES[f])) for f in ARCHS}
    resume_batches = [batch_np(port_cfg(CASES[RESUME]), seed=s) for s in (0, 1)]
    init = {"state": state, "batch": batch, "resume_batches": resume_batches,
            "ckpt_dir": str(base / "ck")}
    worlds, oracle = spawn_world(
        _rank_job, init, base,
        lambda: {n: jax_step(c, state[n], batch[c["family"]])
                 for n, c in CASES.items() if c["jax"]})
    return worlds, oracle, init


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def check_against_jax(got, want, lr, loss_rtol, rtol, tol, move):
    """A mesh step (rank 0's metrics and gathered state) against JAX's on
    the global batch, as ``tests/test_torch_train_families.check_step``."""
    assert got["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=loss_rtol)
    for k in ("ce", "aux", "band_reg", "grad_norm", "lr"):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=rtol, abs=1e-9), k
    for key in ("m", "v"):
        for a, b in zip(got["whole"][key], want[key]):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())
    for a, b, m in zip(got["whole"]["params"], want["params"], want["m"]):
        d = np.abs(a - b)
        assert d.max() <= 2.1 * lr
        sure = np.abs(m) > 2 * tol * np.abs(m).max()     # the gradient's sign is certain
        assert sure.any() and d[sure].max() <= move * lr


def check_against_one_device(got):
    """The mesh step's new moments against the port's one-device step's:
    within 2**-9 of each leaf's largest (and rtol 2**-9)."""
    for key in ("m", "v"):
        for a, b in zip(got["whole"][key], got["one_device"][key]):
            np.testing.assert_allclose(a, b, rtol=ONE_DEVICE_TOL,
                                       atol=ONE_DEVICE_TOL * np.abs(b).max())


def check_counts(reps, cfg, c, dp):
    """Every rank's collectives equal ``collectives_per_train_step`` and
    its K1 calls ``k1_per_train_step`` per microbatch (remat on) through
    the wrapper, none in the other modes."""
    want = collectives_per_train_step(cfg, dp, microbatch=c["microbatch"])
    k1 = k1_per_train_step(cfg) * c["microbatch"] if c["port_mode"] == "kernel" else 0
    for rank, rep in enumerate(reps):
        assert rep["collectives"] == want, rank
        assert rep["k1"] == k1, rank
        assert rep["metrics"] == reps[0]["metrics"], rank


MESH_CASES = [(dp, n) for n, c in CASES.items() for dp in c["dps"]]


@pytest.mark.parametrize("dp,name", [(dp, n) for dp, n in MESH_CASES if CASES[n]["jax"]])
def test_mesh_step_matches_jax_global_step(worlds, runs, dp, name):
    """Rank 0's metrics and the gathered new state against JAX's step on
    the global batch, at the family's mode and tolerances of
    ``tests/test_torch_train_families.py``."""
    from test_torch_train_families import QUANTIZED

    c = CASES[name]
    mode, *tols = QUANTIZED[c["family"]]
    assert mode == c["mode"]
    want = runs[1][name]
    check_against_jax(worlds[dp][0]["cases"][name], want, want["metrics"]["lr"], *tols)


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_mesh_step_matches_the_one_device_port_step(worlds, dp, name):
    got = worlds[dp][0]["cases"][name]
    assert got["metrics"]["loss"] == pytest.approx(got["one_device"]["metrics"]["loss"],
                                                   rel=1e-5)
    check_against_one_device(got)


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_collectives_and_k1_per_step_match_the_counts(worlds, dp, name):
    c = CASES[name]
    check_counts([r["cases"][name] for r in worlds[dp]], port_cfg(c), c, dp)


def _rank_pid(rank, world, fail):
    if rank == fail:
        raise ValueError(f"rank {rank} of {world} fails")
    return rank, os.getpid()


@pytest.mark.parametrize("world", [2, 4])
def test_run_ranks_runs_rank0_here(world):
    """``run_ranks(rank0_here=True)``: rank 0 in this process, done first,
    the others spawned, every rank's result in rank order."""
    got = run_ranks(_rank_pid, world, (-1,), timeout=_WORLD_TIMEOUT, rank0_here=True)
    assert [r for r, _ in got] == list(range(world))
    assert got[0][1] == os.getpid()
    assert len({pid for _, pid in got}) == world


def test_run_ranks_here_raises_a_spawned_ranks_failure():
    with pytest.raises(RuntimeError, match="rank 2 failed"):
        run_ranks(_rank_pid, 4, (2,), timeout=_WORLD_TIMEOUT, rank0_here=True)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("family", ["ssm", "hybrid", "vlm", "audio", "moe"])
def test_band_term_costs_are_the_step_counts_part(family, dp):
    """``launch/dryrun.band_term_costs``: its chunks are the collectives
    and its gathered bytes the bytes the band term adds to a step's
    counts, and a rank keeps its part of what is gathered."""
    cfg = port_cfg(case(family, family, "exact_quant"))
    band = dataclasses.replace(cfg, approx=dataclasses.replace(cfg.approx, band_reg=1e-4))
    none = dataclasses.replace(cfg, approx=dataclasses.replace(cfg.approx, band_reg=0.0))
    got = band_term_costs(band, dp)
    assert got["chunks"] > 0
    assert got["chunks"] == (collectives_per_train_step(band, dp)
                             - collectives_per_train_step(none, dp))
    assert got["gathered_bytes"] == (gathered_bytes_per_train_step(band, dp)
                                     - gathered_bytes_per_train_step(none, dp))
    assert got["kept_bytes"] * dp == got["gathered_bytes"]
    assert band_term_costs(none, dp) == {"chunks": 0, "gathered_bytes": 0, "kept_bytes": 0}


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_step_is_bit_equal_to_no_mesh(worlds, name):
    assert worlds[1][0]["one_rank"][name] == {"metrics": True, "state": True}


def check_checkpoint(worlds, init, c):
    """A state written at dp 2 after one step: restored there, step 2
    gives the run that went on bit for bit; restored at dp 4, each rank
    holds its cut of the whole leaves the checkpoint keeps."""
    for rank, rep in enumerate(worlds[2]):
        assert rep["resume"]["at"] == 1 and rep["resume"]["metrics"], rank
        assert rep["resume"]["state"], rank
    cfg = port_cfg(c)
    whole, at = ckpt.restore_checkpoint(init["ckpt_dir"],
                                        state_from_numpy(init["state"][c["name"]]))
    assert at == 1
    dims = fsdp.data_dims(cfg, WORLD)
    assert any(d is not None for d in dims) and any(d is None for d in dims)
    for rank, rep in enumerate(worlds[WORLD]):
        got = rep["restored"]
        assert got["at"] == 1
        for key, tree in (("params", whole["params"]), ("m", whole["opt"]["m"]),
                          ("v", whole["opt"]["v"])):
            for part, full, dim in zip(got[key], np_tree(tree), dims):
                if dim is not None:
                    n = full.shape[dim] // WORLD
                    full = np.take(full, range(rank * n, (rank + 1) * n), axis=dim)
                np.testing.assert_array_equal(part, full)


def test_ssm_checkpoint_resumes_bit_equal_and_restores_at_dp4(worlds, runs):
    """The ssm state (its Mamba leaves split and whole) through
    ``check_checkpoint``."""
    check_checkpoint(worlds, runs[2], CASES[RESUME])


class _Mesh:
    """One rank of a data axis, as the cuts read it."""

    axis_names = ("data",)

    def __init__(self, rank, size):
        self.rank, self.size, self.shape = rank, size, {"data": size}


@pytest.mark.parametrize("family", ["vlm", "audio"])
@pytest.mark.parametrize("dp,microbatch", [(2, 1), (2, 2), (4, 1)])
def test_rank_rows_cut_embeddings_and_positions(family, dp, microbatch):
    """``fsdp.rank_rows`` gives each rank its slice of every microbatch
    chunk of the embeddings, the labels and the vlm's positions grid."""
    cfg = port_cfg(CASES[family])
    batch = torch_batch(batch_np(cfg))
    assert set(batch) == ({"embeddings", "labels", "positions_thw"} if family == "vlm"
                          else {"embeddings", "labels"})
    size = B // microbatch
    for r in range(dp):
        got = fsdp.rank_rows(batch, cfg, _Mesh(r, dp), microbatch)
        rows = [j * size + r * (size // dp) + i for j in range(microbatch)
                for i in range(size // dp)]
        assert set(got) == set(batch)
        for k, v in got.items():
            assert torch.equal(v, batch[k][rows]), k


@pytest.mark.parametrize("family", list(ARCHS))
def test_every_family_passes_check_data_mesh(family):
    """``check_data_mesh`` refuses no family on a data axis, and refuses a
    model axis for every family but dense, naming item 17."""
    cfg = port_cfg(CASES[family])
    loop.check_data_mesh(cfg, _Mesh(0, 2))

    class _ModelAxis(_Mesh):
        axis_names = ("data", "model")

        def __init__(self, rank, size):
            super().__init__(rank, size)
            self.shape = {"data": size, "model": 2}

    with pytest.raises(NotImplementedError, match="item 17"):
        loop.check_data_mesh(cfg, _ModelAxis(0, 2))


def test_launcher_trains_ssm_and_hybrid_on_a_mesh(tmp_path):
    """``launch/train.py --mesh 2`` trains falcon-mamba-7b and zamba2-2.7b
    at reduced width and resumes at ``--mesh 4``."""
    from repro_torch.launch import train as launch

    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        d = str(tmp_path / arch)
        common = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
                  "--ckpt", d, "--ckpt-every", "1"]
        out = launch.main(common + ["--mesh", "2", "--steps", "1"])
        assert out["start"] == 0 and out["step"] == 1 and np.isfinite(out["losses"]).all()
        out2 = launch.main(common + ["--mesh", "4", "--steps", "2"])
        assert out2["start"] == 1 and out2["step"] == 2 and np.isfinite(out2["losses"]).all()

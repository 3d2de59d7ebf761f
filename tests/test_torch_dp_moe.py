"""Data-parallel training of the moe family with its routing over the
global batch (``make_train_step(..., mesh=DataMesh)``, ``models/moe.py``)
against the JAX package's no-mesh ``make_train_step`` on the whole global
batch and against the port's own one-device step, on the CPU over gloo.

The model is ``reduced_config(qwen2-moe-a2.7b)`` (2 layers, d 128, 4
experts top-2 of ff 256, a shared expert of 128, vocab 512) from the JAX
package's seeded state, on ``tests/test_torch_train_families.py``'s batch
of 4 rows of 16 tokens (64 tokens: a capacity of 40 rows an expert), at
dp 2 and 4, in ``exact_quant`` with the band regularizer
(``tests/test_torch_train_families.py``'s mode and tolerances for the
moe).  JAX's ``moe_ffn`` routes the whole batch's tokens: its capacity
takes the global T, an assignment's rank within its expert counts every
token before it, and its load-balance term spans every token.  Held:

* each layer's kept assignments (in (token, choice) order, the ranks'
  joined in rank order), dropped count and capacity **equal** to those of
  JAX's ``moe_ffn`` in its forward on the global batch, and to the
  port's no-mesh call's in the one-device step;
* the step to JAX's at the moe's tolerances, and to the one-device port
  step at 2**-9 of each moment leaf's largest, its loss and ``aux`` (the
  ranks' mean of their terms) to rtol 1e-5;
* **a batch whose lower rank alone overfills an expert**: rank 0's rows
  repeat one token, so every one of its tokens routes to the same two
  experts, more than a rank-local capacity (16 rows at dp 2, 8 at dp 4)
  holds but within the global one; routed rank by rank on local
  capacities, rank 0 would drop assignments JAX keeps and rank 1 keep
  assignments JAX drops (the test checks that it would), and the mesh
  step's routing is still JAX's.  This step runs in ``float``, held to
  JAX at that file's float tolerances: in ``exact_quant`` the port's own
  one-device step parts from JAX's on this batch (loss by 1.1e-4 of
  itself), since a code that flips on an ulp flips alike in the 32
  identical rows of the repeated token.

Beside that: ``microbatch`` 2 with ``remat`` through K1's wrapper at dp 2
(each microbatch's capacity that of its 32 global tokens), the
collectives and K1 calls per step against ``collectives_per_train_step``
(each layer gathers each expert stack once per use and adds the counts'
all-gather and the dispatch buffers' sum) and ``k1_per_train_step``, a
one-rank mesh step bit-equal to the no-mesh step, a checkpoint written at
dp 2 (the expert stacks split along d) resumed bit for bit and restored
at dp 4, and the launcher at ``--mesh 2``.

One world of 4 ranks is spawned once per module, as
``tests/test_torch_dp_families.py`` spawns its own.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.launch.dryrun import moe_dispatch_costs
from repro_torch.models import moe as M

from test_torch_dp_families import (
    B,
    S,
    case,
    check_against_jax,
    check_against_one_device,
    check_checkpoint,
    check_counts,
    jax_cfg,
    jax_init,
    jax_step,
    one_rank,
    port_cfg,
    restored_parts,
    resume,
    spawn_world,
    step_case,
    world_job,
)
from test_torch_dp_families import batch_np as _base_batch

CASES = {c["name"]: c for c in [
    case("moe", "moe", "exact_quant"),
    case("moe-overfill", "moe", "float", data="overfill"),
    case("moe-mb2-remat", "moe", "lowrank", port_mode="kernel", microbatch=2, remat=True,
         dps=(2,), jax=False),
]}
ONE_RANK = ("moe", "moe-mb2-remat")
RESUME = "moe"
REPEATED = 7                         # the token rank 0's rows repeat in the overfill batch


def batch_np(c):
    """The case's global batch (numpy): the families' batch, or with
    ``data="overfill"`` the same with its first two rows (rank 0's at dp
    2; ranks 0 and 1's at dp 4) one repeated token."""
    b = _base_batch(port_cfg(c))
    if c["data"] == "overfill":
        b["tokens"] = b["tokens"].copy()
        b["tokens"][:2] = REPEATED
    return b


# ---------------------------------------------------------------------------
# the routing, as each side records it
# ---------------------------------------------------------------------------


class RouteLog:
    """Every ``moe.route`` call of the port while installed: its kept
    flags in (token, choice) order, dropped count and capacity, and the
    kept flags the same tokens would get routed alone on a capacity of
    their own T (a rank-local routing)."""

    def __init__(self):
        self.calls, self._route = [], M.route

        def route(x, router, top_k, capacity, mesh=None):
            r = self._route(x, router, top_k, capacity, mesh=mesh)
            T, E = x.shape[0], r.probs.shape[-1]
            local = self._route(x.detach(), router.detach(), top_k,
                                M.moe_capacity(T, top_k, E, 1.25))
            self.calls.append({"keep": _flat(r), "dropped": int((~r.keep).sum()),
                               "capacity": capacity, "local_keep": _flat(local)})
            return r

        M.route = route

    def take(self, one=False):
        out, self.calls = self.calls, []
        return out

    def close(self):
        M.route = self._route


def _flat(r):
    """A routing's kept flags in (token, choice) order."""
    keep = torch.zeros_like(r.keep)
    keep[r.order] = r.keep
    return keep.numpy()


def jax_routing(c, init, batch):
    """Per layer of JAX's forward on the global batch (eager, layers
    unrolled, the same values as its scan), the routing of its
    ``moe_ffn``, from its input and router by its own operations: the kept
    flags in (token, choice) order, dropped count and capacity."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import repro.models.transformer as JT

    cfg = dataclasses.replace(jax_cfg(c), scan_layers=False)
    calls, moe_ffn = [], JT.moe_ffn

    def recorded(x, p, *, top_k, cfg, capacity_factor=1.25, **kw):
        T = x.shape[0]
        E = p.router.shape[-1]
        capacity = int(max(top_k * T * capacity_factor / E, 1))
        capacity = max(8, (min(capacity, T) // 8) * 8)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p.router.astype(jnp.float32), axis=-1)
        _, top_e = jax.lax.top_k(probs, top_k)
        flat_e = top_e.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        counts = jnp.bincount(flat_e, length=E)
        starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
        keep = jnp.arange(T * top_k) - starts[flat_e[order]] < capacity
        calls.append({"keep": np.asarray(jnp.zeros(T * top_k, bool).at[order].set(keep)),
                      "dropped": int((~keep).sum()), "capacity": capacity})
        return moe_ffn(x, p, top_k=top_k, cfg=cfg, capacity_factor=capacity_factor, **kw)

    JT.moe_ffn = recorded
    try:
        params = jax.tree.map(jnp.asarray, init["params"])
        JT.forward(cfg, params, {k: jnp.asarray(v) for k, v in batch.items()
                                 if k != "labels"})
    finally:
        JT.moe_ffn = moe_ffn
    return calls


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _dp_job(mesh, init):
    dp = mesh.size
    if dp == 1:
        return {"one_rank": {n: one_rank(CASES[n], init["state"][n], init["batch"][n], mesh)
                             for n in ONE_RANK}}
    rep = {"cases": {}}
    log = RouteLog()
    try:
        for name, c in CASES.items():
            if dp in c["dps"]:
                log.take()
                rep["cases"][name], _ = step_case(c, init["state"][name], init["batch"][name],
                                                  mesh, on_rank=log.take)
    finally:
        log.close()
    if dp == 2:
        rep["resume"] = resume(CASES[RESUME], init["state"][RESUME], init["resume_batches"],
                               mesh, init["ckpt_dir"])
    else:
        rep["restored"] = restored_parts(CASES[RESUME], init["state"][RESUME], mesh,
                                         init["ckpt_dir"])
    return rep


def _rank_job(rank, world, store_path, init_path):
    return world_job(rank, world, store_path, init_path, _dp_job)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dp_moe")
    state = jax_init(CASES)
    batch = {n: batch_np(c) for n, c in CASES.items()}
    init = {"state": state, "batch": batch, "ckpt_dir": str(base / "ck"),
            "resume_batches": [_base_batch(port_cfg(CASES[RESUME]), seed=s) for s in (0, 1)]}

    def oracle():
        return {n: {**jax_step(c, state[n], batch[n]),
                    "routing": jax_routing(c, state[n], batch[n])}
                for n, c in CASES.items() if c["jax"]}

    worlds, jax_out = spawn_world(_rank_job, init, base, oracle)
    return worlds, jax_out, init


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


MESH_CASES = [(dp, n) for n, c in CASES.items() for dp in c["dps"]]
JAX_CASES = [(dp, n) for dp, n in MESH_CASES if CASES[n]["jax"]]


def _joined(reps, layer, key="keep"):
    """The ranks' flags of one routing call, joined in rank order: the
    global batch's (token, choice) order."""
    return np.concatenate([r["record"][layer][key] for r in reps])


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_routing_equals_the_no_mesh_call(worlds, dp, name):
    """Every routing call of the step (one per layer and microbatch, again
    in each layer's recompute with remat): the ranks' kept flags joined,
    their dropped counts summed and the capacity equal the no-mesh
    call's in the one-device step."""
    reps = [r["cases"][name] for r in worlds[dp]]
    want = reps[0]["one_device"]["record"]
    c = CASES[name]
    assert len(want) == len(reps[0]["record"]) == (
        port_cfg(c).num_layers * c["microbatch"] * (2 if c["remat"] else 1))
    for layer, w in enumerate(want):
        np.testing.assert_array_equal(_joined(reps, layer), w["keep"])
        assert sum(r["record"][layer]["dropped"] for r in reps) == w["dropped"], layer
        assert {r["record"][layer]["capacity"] for r in reps} == {w["capacity"]}, layer


@pytest.mark.parametrize("dp,name", JAX_CASES)
def test_routing_equals_jax_global_routing(worlds, runs, dp, name):
    """Each layer's kept assignments, dropped count and capacity are those
    of JAX's ``moe_ffn`` in its forward on the global batch; both batches
    drop assignments."""
    reps = [r["cases"][name] for r in worlds[dp]]
    want = runs[1][name]["routing"]
    assert len(want) == len(reps[0]["record"]) == port_cfg(CASES[name]).num_layers
    for layer, w in enumerate(want):
        np.testing.assert_array_equal(_joined(reps, layer), w["keep"])
        assert sum(r["record"][layer]["dropped"] for r in reps) == w["dropped"], layer
        assert {r["record"][layer]["capacity"] for r in reps} == {w["capacity"]} == {40}
    assert sum(w["dropped"] for w in want) > 0


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_dispatch_costs_are_the_routing_calls(worlds, dp, name):
    """``launch/dryrun.moe_dispatch_costs`` at a rank's tokens of one
    microbatch gives every routing call's capacity (the global T's) and
    the buffer each rank sums: experts x capacity rows of d float32
    words, more rows than the rank's own assignments fill."""
    c = CASES[name]
    cfg = port_cfg(c)
    got = moe_dispatch_costs(cfg, dp, B * S // c["microbatch"] // dp)
    record = worlds[dp][0]["cases"][name]["record"]
    assert {r["capacity"] for r in record} == {got["capacity"]}
    rows = cfg.moe_experts * got["capacity"]
    assert got["buffer_bytes"] == 4 * rows * cfg.d_model
    assert got["own_rows"] == cfg.moe_top_k * B * S // c["microbatch"] // dp < rows
    assert got["expert_flops"] * got["own_rows"] == got["own_flops"] * rows


@pytest.mark.parametrize("dp", [2, 4])
def test_overfilled_expert_parts_local_routing_from_global(worlds, runs, dp):
    """On the overfill batch rank 0's tokens all route to the same experts,
    past its local capacity: a rank-local routing would drop assignments
    JAX keeps and keep assignments JAX drops, in some layer."""
    reps = [r["cases"]["moe-overfill"] for r in worlds[dp]]
    want = runs[1]["moe-overfill"]["routing"]
    dropped_kept = kept_dropped = False
    for layer, w in enumerate(want):
        local = _joined(reps, layer, "local_keep")
        dropped_kept |= bool((~local & w["keep"]).any())
        kept_dropped |= bool((local & ~w["keep"]).any())
    assert dropped_kept and kept_dropped


@pytest.mark.parametrize("dp,name", JAX_CASES)
def test_mesh_step_matches_jax_global_step(worlds, runs, dp, name):
    """Rank 0's metrics and the gathered new state against JAX's step on
    the global batch, at the moe's mode and tolerances of
    ``tests/test_torch_train_families.py``."""
    from test_torch_train_families import FLOAT, QUANTIZED

    mode, *tols = QUANTIZED["moe"] if CASES[name]["mode"] != "float" else FLOAT
    assert mode == CASES[name]["mode"]
    want = runs[1][name]
    check_against_jax(worlds[dp][0]["cases"][name], want, want["metrics"]["lr"], *tols)


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_mesh_step_matches_the_one_device_port_step(worlds, dp, name):
    got = worlds[dp][0]["cases"][name]
    for k in ("loss", "aux"):
        assert got["metrics"][k] == pytest.approx(got["one_device"]["metrics"][k], rel=1e-5), k
    assert got["metrics"]["aux"] > 0
    check_against_one_device(got)


@pytest.mark.parametrize("dp,name", MESH_CASES)
def test_collectives_and_k1_per_step_match_the_counts(worlds, dp, name):
    c = CASES[name]
    check_counts([r["cases"][name] for r in worlds[dp]], port_cfg(c), c, dp)


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_step_is_bit_equal_to_no_mesh(worlds, name):
    assert worlds[1][0]["one_rank"][name] == {"metrics": True, "state": True}


def test_moe_checkpoint_resumes_bit_equal_and_restores_at_dp4(worlds, runs):
    """The moe state, its expert stacks split along d, through
    ``check_checkpoint``."""
    check_checkpoint(worlds, runs[2], CASES[RESUME])


def test_route_under_a_mesh_takes_the_lower_ranks_counts():
    """``route`` with a mesh whose counts' all-gather is stood in for: each
    rank's slots are the global routing's at its tokens (no process
    group; the lower ranks' counts shift its ranks within experts)."""
    import repro_torch.models.moe as moe_mod

    rng = np.random.default_rng(3)
    T, d, E, k, dp = 32, 8, 4, 2, 4
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(d, E)).astype(np.float32))
    cap = M.moe_capacity(T, k, E, 1.25)
    whole = M.route(x, router, k, cap)
    n = T // dp
    counts = [torch.zeros(E, dtype=torch.int64).scatter_add_(
        0, whole.top_e[r * n:(r + 1) * n].reshape(-1), torch.ones(n * k, dtype=torch.int64))
        for r in range(dp)]

    class _Mesh:
        def __init__(self, rank):
            self.rank, self.size = rank, dp

    gather = moe_mod.all_gather_first
    moe_mod.all_gather_first = lambda t, mesh: torch.cat(counts)
    try:
        parts = [M.route(x[r * n:(r + 1) * n], router, k, cap, mesh=_Mesh(r)) for r in range(dp)]
    finally:
        moe_mod.all_gather_first = gather
    want_keep = _flat(whole)
    want_slot = torch.zeros_like(whole.slot)
    want_slot[whole.order] = whole.slot
    got_slot = []
    for r in parts:
        s = torch.zeros_like(r.slot)
        s[r.order] = r.slot
        got_slot.append(s)
    np.testing.assert_array_equal(np.concatenate([_flat(r) for r in parts]), want_keep)
    kept = torch.from_numpy(want_keep)
    assert torch.equal(torch.cat(got_slot)[kept], want_slot[kept])
    assert not want_keep.all()
    frac = torch.stack(counts).sum(0).float() / T
    for r in parts:
        assert torch.equal(r.frac, frac)


def test_launcher_trains_moe_on_a_mesh(tmp_path):
    """``launch/train.py --mesh 2`` trains qwen2-moe-a2.7b at reduced
    width."""
    from repro_torch.launch import train as launch

    out = launch.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu", "--batch", "4",
                       "--seq", "16", "--ckpt", str(tmp_path / "ck"), "--mesh", "2",
                       "--steps", "1"])
    assert out["start"] == 0 and out["step"] == 1 and np.isfinite(out["losses"]).all()

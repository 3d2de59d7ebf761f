"""MoE serving under a tensor-parallel mesh (``ServeSession(mesh=...)``
over ``torch.distributed``) against the JAX package's no-mesh session, on
the CPU over gloo.

The model is the reduced qwen2-moe-a2.7b (2 layers, d 128, 4 heads, 4
experts top-2, shared expert ff 128, float32) with 4 KV heads, so that
tp 4 holds whole heads.  Where the experts divide the mesh (4 experts at
tp 2 and 4) each rank holds ``E/tp`` whole experts and gathers their
rows (expert parallelism); otherwise (3 experts at tp 2) each expert is
split column/row inside, as the JAX rules split it.  On the JAX test
harness's trace and session, both arms (float through the gather,
``approx`` through K2's plain version against JAX's Pallas kernel in
interpret mode) give the JAX session's greedy tokens and tick count on
every rank, and each rank holds ``1/tp`` of the pool (and, under expert
parallelism, ``1/tp`` of the expert codes).  Beside that: the sharded
``moe_ffn`` against the unsharded one (bit-equal in the integer modes,
and in every mode under expert parallelism; float partial sums within
1e-6 relative), ``shard_params``' expert parts rebuilding the whole leaf,
K1's calls and the collectives per pass against ``k1_per_pass`` and
``collectives_per_pass``, and the dropped assignments against tp=1's.

Each world of ranks is spawned once per module (``launch.mesh.run_ranks``,
a ``FileStore`` under a temporary directory) and runs every case of its
configuration; the tests read its report.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import QWeight, Shard, approx_dense, prequantize_tree
from repro_torch.launch.dryrun import collectives_per_pass, k1_per_pass
from repro_torch.launch.mesh import TPMesh, run_ranks
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.parallel.collectives import all_gather_first
from repro_torch.parallel.tp import shard_params
from repro_torch.serve import ServeSession, resolve_execution_mode

ARCH = "qwen2-moe-a2.7b"
_WORLD_TIMEOUT = 150
# (name, tp, routed experts): expert parallel where tp divides the experts
WORLDS = (("ep2", 2, 4), ("ep4", 4, 4), ("colrow2", 2, 3))
# (name, mode, attn_impl): the JAX TP harness's float and approx arms
ARMS = (("float_gather", "exact", "gather"), ("approx_kernel", "approx", "kernel"))
SESSION = dict(num_slots=2, max_len=64, prompt_buckets=(16,), cache_layout="paged",
               block_size=8, num_blocks=32)
# moe_ffn cases: (mode, weights, shared expert)
FFN = (("approx", "frozen", True), ("exact_quant", "frozen", True), ("approx", "float", True),
       ("exact", "float", True), ("exact", "float", False))


def _cfg(mode: str, experts: int = 4):
    cfg = reduced_config(get_config(ARCH), num_kv_heads=4, moe_experts=experts)
    return dataclasses.replace(cfg, approx=resolve_execution_mode(mode))


def _trace():
    """The JAX TP harness's trace (test_tp_serve.py:42-45)."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 512, int(rng.integers(4, 14))).astype(np.int32), 8)
            for _ in range(4)]


def _expert_bytes(moe):
    """Bytes of a MoE block's routed expert stacks (frozen: their codes)."""
    ws = [w.w if isinstance(w, Shard) else w for w in (moe["w_gate"], moe["w_up"], moe["w_down"])]
    return sum((w.codes if isinstance(w, QWeight) else w).nbytes for w in ws)


# ---------------------------------------------------------------------------
# the rank's side: every case of one world
# ---------------------------------------------------------------------------


class _Counts:
    """K1's calls (the kernel wrapper as ``quantized_matmul`` reaches it)
    and each routing's dropped assignments, while installed."""

    def __init__(self):
        import repro_torch.core.approx as A

        self.k1, self.drops = 0, []
        self._a, self._k1, self._route = A, A.approx_matmul, M.route

        def k1(*a, **kw):
            self.k1 += 1
            return self._k1(*a, **kw)

        def route(*a, **kw):
            r = self._route(*a, **kw)
            self.drops.append(int((~r.keep).sum()))
            return r

        A.approx_matmul, M.route = k1, route

    def close(self):
        self._a.approx_matmul, M.route = self._k1, self._route


def _serve(cfg, params, mesh, attn):
    from repro_torch.parallel.collectives import COUNTS

    counts, calls = _Counts(), COUNTS["calls"]
    try:
        sess = ServeSession(cfg, params, device="cpu", mesh=mesh, attn_impl=attn, **SESSION)
        for i, (p, n) in enumerate(_trace()):
            sess.submit(p, max_new=n, req_id=i)
        res = sess.run(max_steps=1000)
    finally:
        counts.close()
    st = sess.stats
    return {"tokens": {i: r.tokens.tolist() for i, r in res.items()}, "ticks": st.ticks,
            "tp": st.tp, "devices": st.devices, "bytes_dev": st.peak_block_bytes_per_device,
            "pool_bytes": sum(t.numel() * t.element_size() for t in sess.cache.values()),
            "expert_bytes": _expert_bytes(sess.params["layers"]["moe"]), "k1": counts.k1,
            "drops": counts.drops, "collectives": COUNTS["calls"] - calls}


def _ffn_id(mode, weight, shared):
    return f"{mode}-{weight}" + ("" if shared else "-no_shared")


def _ffn_cases(mesh, experts):
    """Each FFN case: ``moe_ffn`` on this rank's part against the whole,
    on the same seeded tokens and weights (T 24 tokens: the capacity binds
    on a skewed router)."""
    rng = np.random.default_rng(11)
    d, ff, sh = 16, 24, 8
    out = {}
    for mode, weight, shared in FFN:
        a = resolve_execution_mode(mode)
        cfg = _cfg(mode, experts)
        p = M.init_moe(torch.Generator().manual_seed(5), d, ff, experts,
                       shared_d_ff=sh if shared else 0)
        p["router"][:, 0] += 2.0
        p = {k: None if v is None else v[None] for k, v in p.items()}   # one stacked layer
        if weight == "frozen":
            p = prequantize_tree({"layers": {"moe": p}}, a)["layers"]["moe"]
        x = torch.from_numpy(rng.standard_normal((24, d)).astype(np.float32) + 0.5)
        want, _ = M.moe_ffn(x, L.unstack(p, 1)[0], top_k=2, cfg=a)
        part = shard_params({"layers": {"moe": p}}, cfg, mesh)["layers"]["moe"]
        got, _ = M.moe_ffn(x, L.unstack(part, 1)[0], top_k=2, cfg=a)
        out[_ffn_id(mode, weight, shared)] = {
            "split": part["w_gate"].split, "equal": bool(torch.equal(got, want)),
            "rel": float((got - want).abs().max() / want.abs().max())}
    return out


def _rank_job(rank, world, store_path, experts, payload):
    torch.set_num_threads(1)
    mesh = TPMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                  backend="gloo", device="cpu")
    try:
        rows = [(torch.arange(6.0) / 7 + r).reshape(2, 3).to(torch.bfloat16)
                for r in range(world)]
        gathered = all_gather_first(rows[rank], mesh)
        rep = {"gather_equal": gathered.dtype == torch.bfloat16
               and bool(torch.equal(gathered, torch.cat(rows))),
               "ffn": _ffn_cases(mesh, experts), "arms": {}}
        for name, mode, attn in ARMS:
            cfg = _cfg(mode, experts)
            params = payload[experts]["frozen" if mode == "approx" else "float"]
            rep["arms"][name] = {"tp": _serve(cfg, params, mesh, attn),
                                 "tp1": _serve(cfg, params, None, attn)}
        return rep
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# fixtures: the JAX oracle and the worlds
# ---------------------------------------------------------------------------


def _jcfg(experts):
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced

    return dataclasses.replace(jreduced(jget(ARCH)), num_kv_heads=4, moe_experts=experts,
                               q_chunk=64)


@pytest.fixture(scope="module")
def payload():
    """Per expert count: the JAX package's weights, float and frozen, in
    both packages."""
    import jax

    from repro.models.transformer import init_params as jinit
    from repro.serve.engine import freeze_params as jfreeze
    from repro.serve.engine import resolve_execution_mode as jresolve
    from repro_torch.bridge import params_from_numpy

    out = {}
    for experts in sorted({e for _, _, e in WORLDS}):
        jcfg = _jcfg(experts)
        jp = jinit(jcfg, jax.random.PRNGKey(0))
        jfrozen = jfreeze(dataclasses.replace(jcfg, approx=jresolve("approx")), jp)
        out[experts] = {"jax": {"exact": jp, "approx": jfrozen},
                        "float": params_from_numpy(jax.tree.map(np.asarray, jp)),
                        "frozen": params_from_numpy(jax.tree.map(np.asarray, jfrozen))}
    return out


@pytest.fixture(scope="module")
def jax_oracle(payload):
    """(experts, arm) -> the JAX no-mesh session's tokens, ticks, bytes."""
    from repro.serve.engine import resolve_execution_mode as jresolve
    from repro.serve.scheduler import ServeSession as JServeSession

    out = {}
    for experts in payload:
        for name, mode, attn in ARMS:
            jcfg = dataclasses.replace(_jcfg(experts), approx=jresolve(mode))
            sess = JServeSession(jcfg, payload[experts]["jax"][mode], **SESSION,
                                 attn_impl="pallas" if attn == "kernel" else "gather")
            for i, (p, n) in enumerate(_trace()):
                sess.submit(p, max_new=n, req_id=i)
            res = sess.run()
            out[(experts, name)] = {"tokens": {i: r.tokens.tolist() for i, r in res.items()},
                                    "ticks": sess.stats.ticks,
                                    "bytes_dev": sess.stats.peak_block_bytes_per_device}
    return out


@pytest.fixture(scope="module")
def worlds(payload, tmp_path_factory):
    """World name -> each rank's report."""
    ship = {e: {k: v[k] for k in ("float", "frozen")} for e, v in payload.items()}
    out = {}
    for name, tp, experts in WORLDS:
        store = tmp_path_factory.mktemp(name) / "store"
        out[name] = run_ranks(_rank_job, tp, (str(store), experts, ship),
                              timeout=_WORLD_TIMEOUT)
    return out


def _world(name):
    return next(w for w in WORLDS if w[0] == name)


# ---------------------------------------------------------------------------
# the cuts, without a process group
# ---------------------------------------------------------------------------


class _Mesh:
    """A mesh's shape and one rank's index, as ``shard_params`` reads them."""

    axis_names = ("model",)

    def __init__(self, rank, size):
        self.rank, self.size, self.shape = rank, size, {"model": size}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_expert_parts_rebuild_the_whole(payload, tp):
    """Each rank holds E/tp whole experts of every routed stack, every
    QWeight field with them; the shared expert splits column/row, the
    routers stay whole; a leaf cut on dim -3 is an expert Shard."""
    cfg = _cfg("approx")
    full = payload[4]["frozen"]
    parts = [shard_params(full, cfg, _Mesh(r, tp))["layers"]["moe"] for r in range(tp)]
    whole = full["layers"]["moe"]
    for key in ("w_gate", "w_up", "w_down"):
        assert [p[key].split for p in parts] == ["expert"] * tp
        for f in QWeight._fields:
            got = [getattr(p[key].w, f) for p in parts]
            assert got[0].shape[-3] == cfg.moe_experts // tp, (key, f)
            assert torch.equal(torch.cat(got, dim=-3), getattr(whole[key], f)), (key, f)
    assert [p["shared_gate"].split for p in parts] == ["column"] * tp
    assert [p["shared_down"].split for p in parts] == ["row"] * tp
    assert all(p["router"] is whole["router"] and p["shared_router"] is whole["shared_router"]
               for p in parts)
    assert _expert_bytes(parts[0]) * tp == _expert_bytes(whole)


def test_shard_params_splits_each_expert_where_the_experts_do_not_divide(payload):
    """3 experts at tp 2: w_gate/w_up by output column (per-channel
    fields with them), w_down by input row (fields whole), in every
    expert."""
    cfg = _cfg("approx", 3)
    full = payload[3]["frozen"]
    parts = [shard_params(full, cfg, _Mesh(r, 2))["layers"]["moe"] for r in range(2)]
    whole = full["layers"]["moe"]
    for key, split, dim in (("w_gate", "column", -1), ("w_up", "column", -1),
                            ("w_down", "row", -2)):
        assert [p[key].split for p in parts] == [split] * 2
        assert torch.equal(torch.cat([p[key].w.codes for p in parts], dim), whole[key].codes)
        for f in ("scale", "zero_point", "col_sum"):
            got = [getattr(p[key].w, f) for p in parts]
            joined = torch.cat(got, -1) if split == "column" else got[0]
            assert torch.equal(joined, getattr(whole[key], f)), (key, f)


def test_approx_dense_refuses_an_expert_shard(payload):
    part = shard_params(payload[4]["frozen"], _cfg("approx"), _Mesh(0, 2))
    w = L.unstack(part["layers"]["moe"]["w_gate"], 2)[0]
    assert isinstance(w, Shard) and w.split == "expert"
    with pytest.raises(ValueError, match="expert Shard"):
        approx_dense(torch.zeros(3, 128), w, _cfg("approx").approx)


@pytest.mark.parametrize("experts,tp,quantized,float_", [(4, 2, 12, 8), (4, 4, 12, 8),
                                                          (3, 2, 22, 12)])
def test_collectives_per_pass_counts_the_splits(experts, tp, quantized, float_):
    """Per layer: wo and shared_down (each two reductions in a quantized
    mode, one in float) and the experts' gather, or each expert's w_down
    (3 experts at tp 2); then the vocab-split embedding and the head's
    all-gather."""
    assert collectives_per_pass(_cfg("approx", experts), tp) == quantized
    assert collectives_per_pass(_cfg("exact", experts), tp) == float_


# ---------------------------------------------------------------------------
# the worlds against the unsharded block and the JAX no-mesh session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
def test_all_gather_first_moves_bits(worlds, world):
    assert all(rep["gather_equal"] for rep in worlds[world])


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
@pytest.mark.parametrize("case", [_ffn_id(*c) for c in FFN])
def test_sharded_moe_ffn_equals_unsharded(worlds, world, case):
    """Frozen weights in the integer modes: bit-equal on every rank (the
    row splits sum exact integers).  Under expert parallelism the routed
    experts' part is bit-equal in every mode (each expert's projections
    at tp=1's shapes, the gather moves bits): so is a block without a
    shared expert.  Float partial sums (the shared expert's row split in
    float mode, a float weight's straight-through y_lin, each expert's
    w_down under the column/row split): within 1e-6 relative."""
    _, tp, experts = _world(world)
    ep = experts % tp == 0
    for rank, rep in enumerate(worlds[world]):
        r = rep["ffn"][case]
        assert r["split"] == ("expert" if ep else "column"), (rank, r)
        if case.endswith("frozen") or (ep and case.endswith("no_shared")):
            assert r["equal"], (rank, r)
        else:
            assert r["rel"] <= 1e-6, (rank, r)


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_moe_session_matches_jax_no_mesh_session(worlds, jax_oracle, world, arm):
    """Identical greedy tokens on every rank and the same tick count."""
    _, tp, experts = _world(world)
    want = jax_oracle[(experts, arm)]
    for rank, rep in enumerate(worlds[world]):
        got = rep["arms"][arm]
        for run in (got["tp"], got["tp1"]):
            assert run["tokens"] == want["tokens"], (rank, run["tokens"], want["tokens"])
            assert run["ticks"] == want["ticks"], rank


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_moe_rank_holds_one_tp_th(worlds, jax_oracle, world, arm):
    """Each rank's pool and peak block bytes are 1/tp of tp=1's (and of
    the JAX session's); under expert parallelism its expert codes are
    1/tp of the whole, else all experts' codes split inside; stats.tp and
    stats.devices are tp."""
    _, tp, experts = _world(world)
    for rep in worlds[world]:
        got, one = rep["arms"][arm]["tp"], rep["arms"][arm]["tp1"]
        assert got["bytes_dev"] > 0
        assert got["bytes_dev"] * tp == one["bytes_dev"] == jax_oracle[(experts, arm)]["bytes_dev"]
        assert got["pool_bytes"] * tp == one["pool_bytes"]
        if experts % tp == 0:
            assert got["expert_bytes"] * tp == one["expert_bytes"] > 0
        assert got["tp"] == got["devices"] == tp
        assert one["tp"] == one["devices"] == 1


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
def test_moe_k1_calls_per_pass_per_rank(worlds, world):
    """K1 calls per rank and pass: L (4 + 3 E/tp + 3) + 1 under expert
    parallelism, tp=1's L (4 + 3 E + 3) + 1 under the column/row split;
    the passes are tp=1's."""
    _, tp, experts = _world(world)
    cfg = _cfg("approx", experts)
    for rep in worlds[world]:
        got, one = rep["arms"]["approx_kernel"]["tp"], rep["arms"]["approx_kernel"]["tp1"]
        passes, rest = divmod(one["k1"], k1_per_pass(cfg))
        assert rest == 0 and passes > 0
        assert got["k1"] == k1_per_pass(cfg, tp) * passes
        if experts % tp == 0:
            L_, E = cfg.num_layers, cfg.moe_experts
            assert k1_per_pass(cfg, tp) == L_ * (4 + 3 * E // tp + 3) + 1


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_moe_collectives_per_pass(worlds, world, arm):
    _, tp, experts = _world(world)
    mode = dict((a[0], a[1]) for a in ARMS)[arm]
    cfg = _cfg(mode, experts)
    for rep in worlds[world]:
        one = rep["arms"]["approx_kernel"]["tp1"]
        passes = one["k1"] // k1_per_pass(_cfg("approx", experts))
        assert rep["arms"][arm]["tp"]["collectives"] == collectives_per_pass(cfg, tp) * passes
        assert rep["arms"][arm]["tp1"]["collectives"] == 0


@pytest.mark.parametrize("world", [w[0] for w in WORLDS])
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_moe_dropped_assignments_equal_tp1(worlds, world, arm):
    for rep in worlds[world]:
        got, one = rep["arms"][arm]["tp"], rep["arms"][arm]["tp1"]
        assert got["drops"] == one["drops"]
        assert sum(one["drops"]) > 0                    # the capacity bound somewhere

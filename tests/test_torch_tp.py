"""Tensor-parallel serving of the port (``ServeSession(mesh=...)`` over
``torch.distributed``) against the JAX package's no-mesh session, on the
CPU over gloo.

The contract is the JAX package's own TP tests' (``tests/test_tp_serve.py``):
on a ``(tp,)`` ``"model"`` mesh the greedy tokens and the tick count equal
the no-mesh session's, each rank holds exactly ``1/tp`` of the paged pool,
and ``stats.tp`` and ``stats.devices`` say so.  Its harness config and
trace are used here at tp 2 and 4 on its three arms: float through the
gather, ``approx`` through K2 (its plain version on the CPU; the JAX
oracle through its Pallas kernel in interpret mode) and exact spec decode.
Beside that: the row- and column-parallel ``approx_dense`` against the
unsharded call (bit-equal in the integer modes), the vocab-parallel
embedding, one decode step's logits, the session's features at tp 2, the
constructor's checks on a one-rank group and the launcher's ``--tp``.

Each world of ranks is spawned once per module (``launch.mesh.run_ranks``,
a ``FileStore`` under a temporary directory, one thread per rank) and runs
every case of its tp; the tests read its report.  A world that hangs fails
after ``_WORLD_TIMEOUT`` seconds.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.approx import Shard, approx_dense, prequantize_tree
from repro_torch.kernels.paged_attention import validate_tp_heads
from repro_torch.launch.mesh import TPMesh, run_ranks
from repro_torch.models import layers as L
from repro_torch.models.transformer import forward, init_paged_cache, paged_decode_step
from repro_torch.parallel.tp import shard_cache, shard_params
from repro_torch.serve import ServeSession, resolve_execution_mode, scatter_prompt_blocks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORLD_TIMEOUT = 150
TPS = (2, 4)
# the JAX test's matrix (test_tp_serve.py:115-119): (name, mode, session kwargs)
ARMS = (("float_gather", "exact", dict(attn_impl="gather")),
        ("approx_kernel", "approx", dict(attn_impl="kernel")),
        ("spec_exact", "exact", dict(attn_impl="gather", spec_decode=True, draft_k=2,
                                      draft_mode="exact")))
SESSION = dict(num_slots=2, max_len=64, prompt_buckets=(16,), cache_layout="paged",
               block_size=8, num_blocks=32)
# the session's features at tp 2: (name, mode, session kwargs, trace)
FEATURES = (
    ("prefix_sharing", "approx", dict(attn_impl="kernel", prefix_sharing=True,
                                      prompt_buckets=(16, 32)), "shared"),
    ("chunked_prefill", "approx", dict(attn_impl="kernel", chunked_prefill=True,
                                       prefill_chunk=8, prompt_buckets=(8, 16)), "long"),
    ("sync_loop", "approx", dict(attn_impl="kernel", loop="sync"), "jax"),
    ("preemption", "approx", dict(attn_impl="kernel", preemption=True, num_blocks=5,
                                  prompt_buckets=(16, 32)), "jax"),
    ("tiers", "exact", dict(attn_impl="kernel", tiers=("exact", "approx")), "tiers"),
)
# approx_dense cases: (split, weight, per-row activation scales, mode)
DENSE = list(itertools.product(("row", "column"), ("frozen", "float"), (False, True),
                               ("approx", "exact_quant")))
FLOAT_DENSE = [("row", "float", False, "exact"), ("column", "float", False, "exact")]


def _cfg(mode: str, **kw):
    """The JAX TP harness's config (test_tp_serve.py:35-39) in ``mode``."""
    cfg = dataclasses.replace(
        reduced_config(get_config("granite-3-2b")), num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, remat=False, dtype="float32")
    return dataclasses.replace(cfg, approx=resolve_execution_mode(mode, **kw))


def _trace(kind: str = "jax"):
    """The JAX harness's trace (test_tp_serve.py:42-45), or a feature's."""
    rng = np.random.default_rng(0)
    if kind == "jax":
        return [(rng.integers(0, 512, int(rng.integers(4, 14))).astype(np.int32), 8, None)
                for _ in range(4)]
    if kind == "shared":            # a 16-token system prompt, two blocks
        head = rng.integers(0, 512, 16)
        return [(np.concatenate([head, rng.integers(0, 512, int(rng.integers(1, 9)))]), 6, None)
                for _ in range(4)]
    if kind == "long":              # past the largest bucket: chunked only
        return [(rng.integers(0, 512, int(rng.integers(4, 30))), 6, None) for _ in range(4)]
    return [(rng.integers(0, 512, int(rng.integers(4, 14))), 6, ("exact", "approx")[i % 2])
            for i in range(4)]


def _serve(cfg, params, mesh, kw, trace):
    sess = ServeSession(cfg, params, device="cpu", mesh=mesh, **{**SESSION, **kw})
    for i, (p, n, tier) in enumerate(trace):
        sess.submit(p, max_new=n, req_id=i, tier=tier)
    res = sess.run(max_steps=1000)
    st = sess.stats
    return sess, {"tokens": {i: r.tokens.tolist() for i, r in res.items()}, "ticks": st.ticks,
                  "tp": st.tp, "devices": st.devices,
                  "bytes_dev": st.peak_block_bytes_per_device,
                  "prefix_hit_blocks": st.prefix_hit_blocks, "preemptions": st.preemptions,
                  "prefill_chunks": st.prefill_chunks}


def _params(payload, mode):
    return payload["frozen"] if mode == "approx" else payload["float"]


# ---------------------------------------------------------------------------
# the rank's side: every case of one tp in one world
# ---------------------------------------------------------------------------


def _shard_of(w, split: str, mesh):
    """The (1, K, N) stacked ``w`` cut by ``shard_params``'s rules as
    ``wo`` (row) or ``wq`` (column), then its one layer."""
    attn = {"wq": w, "wk": w, "wv": w, "wo": w}         # the field order names ``.wo``
    tree = shard_params({"layers": {"attn": attn}}, _cfg("exact"), mesh)
    part = tree["layers"]["attn"]["wo" if split == "row" else "wq"]
    assert isinstance(part, Shard) and part.split == split
    return L.unstack(part, 1)[0]


def _dense_cases(mesh):
    """Each DENSE case and float mode: the sharded call on this rank's part
    against the unsharded call on the whole, on the same seeded inputs."""
    rng = np.random.default_rng(7)
    K, N, r, tp = 64, 48, mesh.rank, mesh.size
    out = {}
    for case in DENSE + FLOAT_DENSE:
        split, weight, per_row, mode = case
        a = resolve_execution_mode(mode, act_per_row=per_row)
        x = torch.from_numpy(rng.standard_normal((3, 5, K)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((1, K, N)).astype(np.float32) * 0.1)
        if weight == "frozen":
            w = prequantize_tree({"wq": w}, a)["wq"]
        want = approx_dense(x, L.unstack(w, 1)[0], a)
        shard = _shard_of(w, split, mesh)
        if split == "row":
            got = approx_dense(x[..., r * K // tp:(r + 1) * K // tp], shard, a)
        else:
            got = approx_dense(x, shard, a)
            want = want[..., r * N // tp:(r + 1) * N // tp]
        out["-".join(map(str, case))] = {
            "equal": bool(torch.equal(got, want)),
            "rel": float((got - want).abs().max() / want.abs().max())}
    return out


def _embed_case(mesh):
    table = torch.from_numpy(np.random.default_rng(3).standard_normal((512, 16))
                             .astype(np.float32))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (3, 7)))
    tree = shard_params({"embed": table}, _cfg("exact"), mesh)
    assert isinstance(tree["embed"], Shard) and tree["embed"].split == "vocab"
    return bool(torch.equal(L.embed(toks, tree["embed"]), L.embed(toks, table)))


def _decode_logits(cfg, params, mesh):
    """One paged decode step after a prefill, sharded against whole: the
    max |difference| of the logits."""
    bs, nb = 8, 8
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 16)))
    _, kvs = forward(cfg, params, toks, return_kv=True)
    pool = init_paged_cache(cfg, nb, bs)
    tables = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    scatter_prompt_blocks(pool, kvs, tables[:, :2], bs)
    part = shard_cache(cfg, mesh, pool)
    cur = torch.tensor([16, 11])
    last = torch.tensor([[3], [9]])
    want = paged_decode_step(cfg, params, pool, last, cur, tables, block_size=bs,
                             attn_impl="kernel")
    got = paged_decode_step(cfg, shard_params(params, cfg, mesh), part, last, cur, tables,
                            block_size=bs, attn_impl="kernel")
    return float((got - want).abs().max())


def _rank_job(rank, world, store_path, payload):
    torch.set_num_threads(1)
    mesh = TPMesh(rank=rank, world=world, store=dist.FileStore(store_path, world),
                  backend="gloo", device="cpu")
    try:
        rep = {"dense": _dense_cases(mesh), "embed_equal": _embed_case(mesh), "arms": {},
               "features": {}, "logits": {}}
        for name, mode, kw in ARMS:
            cfg = _cfg(mode)
            sess, got = _serve(cfg, _params(payload, mode), mesh, kw, _trace())
            one, want = _serve(cfg, _params(payload, mode), None, kw, _trace())
            got["pool_bytes"] = sum(t.numel() * t.element_size() for t in sess.cache.values())
            got["tp1"] = want
            got["tp1_pool_bytes"] = sum(t.numel() * t.element_size()
                                        for t in one.cache.values())
            cut = shard_cache(cfg, mesh, one.cache)
            got["pool_diff"] = [[float((sess.cache[k][i] - cut[k][i]).abs().max())
                                 for i in range(cfg.num_layers)] for k in ("k", "v")]
            rep["arms"][name] = got
        for mode in ("exact", "approx"):
            rep["logits"][mode] = _decode_logits(_cfg(mode), _params(payload, mode), mesh)
        if world == 2:
            for name, mode, kw, trace in FEATURES:
                cfg = _cfg(mode, act_per_row=True) if name == "tiers" else _cfg(mode)
                _, got = _serve(cfg, _params(payload, mode), mesh, kw, _trace(trace))
                _, want = _serve(cfg, _params(payload, mode), None, kw, _trace(trace))
                rep["features"][name] = (got, want)
        return rep
    finally:
        mesh.close()


# ---------------------------------------------------------------------------
# fixtures: the JAX oracle and the worlds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def payload():
    import jax

    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models.transformer import init_params as jinit
    from repro.serve.engine import freeze_params as jfreeze
    from repro.serve.engine import resolve_execution_mode as jresolve
    from repro_torch.bridge import params_from_numpy

    jcfg = dataclasses.replace(
        jreduced(jget("granite-3-2b")), num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, remat=False, q_chunk=64, dtype="float32")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    jcfgs = {"exact": jcfg, "approx": dataclasses.replace(jcfg, approx=jresolve("approx"))}
    jfrozen = jfreeze(jcfgs["approx"], jp)
    return {"jcfgs": jcfgs, "jparams": {"exact": jp, "approx": jfrozen},
            "float": params_from_numpy(jax.tree.map(np.asarray, jp)),
            "frozen": params_from_numpy(jax.tree.map(np.asarray, jfrozen))}


@pytest.fixture(scope="module")
def jax_oracle(payload):
    """The JAX no-mesh session of each arm: tokens, ticks, pool bytes."""
    from repro.serve.scheduler import ServeSession as JServeSession

    out = {}
    for name, mode, kw in ARMS:
        jkw = dict(kw, attn_impl="pallas" if kw["attn_impl"] == "kernel" else "gather")
        sess = JServeSession(payload["jcfgs"][mode], payload["jparams"][mode], **SESSION,
                             **jkw)
        for i, (p, n, _) in enumerate(_trace()):
            sess.submit(p, max_new=n, req_id=i)
        res = sess.run()
        out[name] = {"tokens": {i: r.tokens.tolist() for i, r in res.items()},
                     "ticks": sess.stats.ticks,
                     "bytes_dev": sess.stats.peak_block_bytes_per_device}
    return out


@pytest.fixture(scope="module")
def worlds(payload, tmp_path_factory):
    """tp -> each rank's report."""
    ship = {k: payload[k] for k in ("float", "frozen")}
    out = {}
    for tp in TPS:
        store = tmp_path_factory.mktemp(f"tp{tp}") / "store"
        out[tp] = run_ranks(_rank_job, tp, (str(store), ship), timeout=_WORLD_TIMEOUT)
    return out


# ---------------------------------------------------------------------------
# (a) validate_tp_heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,ok", [((8, 4, 2), True), ((4, 4, 4), True), ((8, 4, 0), False),
                                      ((8, 4, 3), False), ((8, 2, 4), False),
                                      ((12, 8, 4), False)])
def test_validate_tp_heads_cases(heads, ok):
    """The JAX test's cases (test_tp_serve.py:122-132)."""
    if ok:
        validate_tp_heads(*heads)
    else:
        with pytest.raises(ValueError):
            validate_tp_heads(*heads)


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (12, 4), (16, 8), (32, 8)])
def test_validate_tp_heads_agrees_with_jax(H, Hkv):
    from repro.kernels.paged_attention import validate_tp_heads as jvalidate

    for tp in range(0, 9):
        errs = []
        for fn in (validate_tp_heads, jvalidate):
            try:
                fn(H, Hkv, tp)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], (H, Hkv, tp)


# ---------------------------------------------------------------------------
# the cuts, without a process group
# ---------------------------------------------------------------------------


class _Mesh:
    """A mesh's shape and one rank's index, as ``shard_params`` reads them."""

    axis_names = ("model",)

    def __init__(self, rank, size):
        self.rank, self.size, self.shape = rank, size, {"model": size}


@pytest.mark.parametrize("tp", TPS)
def test_shard_params_parts_rebuild_the_whole(payload, tp):
    """Every rank's part, joined in rank order, is the whole leaf: column
    splits along the output columns (a frozen weight's per-channel fields
    with them), row splits along the input rows (fields whole), the
    vocab-split embedding along its rows; norms stay whole."""
    cfg = _cfg("approx")
    full = payload["frozen"]
    parts = [shard_params(full, cfg, _Mesh(r, tp)) for r in range(tp)]
    att = [p["layers"]["attn"] for p in parts]
    assert all(a["wq"].split == "column" and a["wo"].split == "row" for a in att)
    for key, dim in (("wq", -1), ("wk", -1), ("wv", -1), ("wo", -2)):
        whole = full["layers"]["attn"][key]
        got = [a[key].w for a in att]
        assert torch.equal(torch.cat([g.codes for g in got], dim=dim), whole.codes), key
        for f in ("scale", "zero_point", "col_sum"):
            joined = torch.cat([getattr(g, f) for g in got], dim=-1) if dim == -1 \
                else getattr(got[0], f)
            assert torch.equal(joined, getattr(whole, f)), (key, f)
    ffn = [p["layers"]["ffn"] for p in parts]
    assert [f["w_down"].split for f in ffn] == ["row"] * tp
    assert torch.equal(torch.cat([p["lm_head"].w.codes for p in parts], -1),
                       full["lm_head"].codes)
    assert torch.equal(torch.cat([p["embed"].w for p in parts], 0), full["embed"])
    assert all(p["final_norm"] is full["final_norm"] for p in parts)


def test_shard_params_leaves_an_odd_vocab_whole():
    """granite's 49,155-row embedding does not split over 2; its padded
    head (49,664 columns) does."""
    cfg = get_config("granite-3-2b")
    tree = {"embed": torch.zeros((cfg.vocab_size, 4)),
            "lm_head": torch.zeros((4, cfg.padded_vocab))}
    part = shard_params(tree, cfg, _Mesh(1, 2))
    assert part["embed"] is tree["embed"]
    assert isinstance(part["lm_head"], Shard) and part["lm_head"].w.shape == (4, 24832)


@pytest.mark.parametrize("tp", TPS)
def test_shard_cache_keeps_the_ranks_kv_heads(tp):
    cfg = _cfg("exact")
    pool = init_paged_cache(cfg, 6, 8)
    pool["k"].copy_(torch.randn(pool["k"].shape))
    parts = [shard_cache(cfg, _Mesh(r, tp), pool) for r in range(tp)]
    assert parts[0]["k"].shape == (2, 7, 8, 4 // tp, 16)
    assert torch.equal(torch.cat([p["k"] for p in parts], dim=3), pool["k"])


# ---------------------------------------------------------------------------
# (b) the constructor's checks on a one-rank group
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh1(tmp_path):
    mesh = TPMesh(rank=0, world=1, store=dist.FileStore(str(tmp_path / "store"), 1),
                  backend="gloo", device="cpu")
    yield mesh
    mesh.close()


def test_mesh_ctor_validation(payload, mesh1):
    """test_tp_serve.py:135-168 on a one-rank gloo group."""
    cfg = dataclasses.replace(_cfg("exact"), num_layers=1)
    params = payload["float"]
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServeSession(cfg, params, cache_layout="slots", mesh=mesh1, **kw)
    with pytest.raises(ValueError, match="model"):
        ServeSession(cfg, params, cache_layout="paged", block_size=8, num_blocks=16,
                     mesh=mesh1, tp_axis="tp", **kw)
    sess = ServeSession(cfg, _cut_layers(params, 1), cache_layout="paged", block_size=8,
                        num_blocks=16, mesh=mesh1, **kw)
    sess.submit(np.arange(4, dtype=np.int32), max_new=4)
    res = sess.run()
    assert len(res[0].tokens) == 4
    assert sess.stats.tp == 1 and sess.stats.devices == 1


def _cut_layers(params, n):
    return {**params, "layers": {k: ({f: v[:n] for f, v in d.items()} if isinstance(d, dict)
                                     else d[:n]) for k, d in params["layers"].items()}}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("layout", ["paged", "slots"])
def test_mesh_refuses_a_family_without_a_paged_pool(mesh1, arch, layout):
    """The ssm and hybrid families under a mesh: the session raises JAX's
    message (the paged pool refuses their O(1) state; the slot layout
    refuses a mesh), and ``shard_params`` raises."""
    import jax

    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.models.transformer import init_params as jinit
    from repro.serve.scheduler import ServeSession as JServeSession
    from repro_torch.models.transformer import init_params

    cfg, jcfg = reduced_config(get_config(arch)), jreduced(jget(arch))
    kw = dict(num_slots=2, max_len=32, prompt_buckets=(8,), block_size=8, cache_layout=layout)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))
    with pytest.raises(ValueError) as want:
        JServeSession(jcfg, jinit(jcfg, jax.random.PRNGKey(0)), mesh=jmesh, **kw)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError) as got:
        ServeSession(cfg, params, mesh=mesh1, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="paged"):
        shard_params(params, cfg, mesh1)


# ---------------------------------------------------------------------------
# (c) approx_dense and the embedding, sharded against whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", DENSE + FLOAT_DENSE, ids=lambda c: "-".join(map(str, c)))
def test_approx_dense_sharded_equals_unsharded(worlds, tp, case):
    """Frozen weights in the integer modes: bit-equal on every rank.  A
    float weight's straight-through value (y_lin summed over the ranks in
    float32) and float mode: within 1e-6 relative."""
    split, weight, _, mode = case
    for rank, rep in enumerate(worlds[tp]):
        r = rep["dense"]["-".join(map(str, case))]
        if weight == "frozen":
            assert r["equal"], (rank, r)
        else:
            assert r["rel"] <= 1e-6, (rank, r)


@pytest.mark.parametrize("tp", TPS)
def test_vocab_parallel_embedding_is_exact(worlds, tp):
    assert all(rep["embed_equal"] for rep in worlds[tp])


# ---------------------------------------------------------------------------
# (d) the JAX test's matrix against the JAX no-mesh session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_tp_session_matches_jax_no_mesh_session(worlds, jax_oracle, tp, arm):
    """Identical greedy tokens on every rank and the same tick count."""
    want = jax_oracle[arm]
    for rank, rep in enumerate(worlds[tp]):
        got = rep["arms"][arm]
        assert got["tokens"] == want["tokens"], (rank, got["tokens"], want["tokens"])
        assert got["ticks"] == want["ticks"], rank


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_tp_pool_is_one_tp_th_per_rank(worlds, jax_oracle, tp, arm):
    """Each rank's peak block bytes times tp equal the tp=1 port session's
    and the JAX session's; each rank holds 1/tp of the pool; stats.tp and
    stats.devices are tp."""
    for rep in worlds[tp]:
        got = rep["arms"][arm]
        assert got["bytes_dev"] > 0
        assert got["bytes_dev"] * tp == got["tp1"]["bytes_dev"] == jax_oracle[arm]["bytes_dev"]
        assert got["pool_bytes"] * tp == got["tp1_pool_bytes"]
        assert got["tp"] == got["devices"] == tp
        assert got["tp1"]["tp"] == got["tp1"]["devices"] == 1


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_tp_pool_holds_the_tp1_pools_heads(worlds, tp, arm):
    """After the run each rank's pool is its KV heads of the tp=1
    session's pool: layer 0's K/V bit for bit (column-parallel projections
    of the same embedding), later layers within 1e-5 (on the CPU the
    attention of fewer heads rounds otherwise, which moves a per-tensor
    activation scale by an ulp at tp 4; at tp 2 the approx arm's pool is
    bit-equal too)."""
    for rep in worlds[tp]:
        diff = rep["arms"][arm]["pool_diff"]               # [k, v] x layers
        assert diff[0][0] == diff[1][0] == 0.0, diff
        assert max(max(d) for d in diff) <= 1e-5, diff
        if tp == 2 and arm == "approx_kernel":
            assert max(max(d) for d in diff) == 0.0, diff


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_tp_decode_step_logits_match_tp1(worlds, tp, mode):
    assert all(rep["logits"][mode] <= 1e-5 for rep in worlds[tp])


# ---------------------------------------------------------------------------
# (e) the session's features at tp 2 against the port's tp=1 session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feature", [f[0] for f in FEATURES])
def test_tp2_feature_matches_tp1(worlds, feature):
    for rank, rep in enumerate(worlds[2]):
        got, want = rep["features"][feature]
        assert got["tokens"] == want["tokens"], (rank, feature)
        for k in ("ticks", "prefix_hit_blocks", "preemptions", "prefill_chunks"):
            assert got[k] == want[k], (rank, feature, k)
    got = worlds[2][0]["features"][feature][0]
    seen = {"prefix_sharing": got["prefix_hit_blocks"], "preemption": got["preemptions"],
            "chunked_prefill": got["prefill_chunks"]}
    assert seen.get(feature, 1) > 0, feature         # the feature did its work


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
                           "--device", "cpu", "--requests", "4", "--new", "4", *args],
                          capture_output=True, text=True, env=env, cwd=_ROOT, timeout=240)


def _tp2_prints_the_tp0_tokens(*args):
    one, two = _launch("--tp", "0", *args), _launch("--tp", "2", *args)
    assert one.returncode == 0, one.stderr[-2000:]
    assert two.returncode == 0, two.stderr[-2000:]
    sample = [next(ln for ln in r.stdout.splitlines() if ln.startswith("sample:"))
              for r in (one, two)]
    assert sample[0] == sample[1]
    assert "tensor parallel: tp=2 over 2 devices" in two.stdout
    assert two.stdout.count("sample:") == 1                  # rank 0 prints alone


def test_launcher_tp2_prints_the_tp0_tokens():
    _tp2_prints_the_tp0_tokens()


def test_launcher_tp2_moe_prints_the_tp0_tokens():
    """qwen2-moe's 4 reduced experts split by expert over the 2 ranks."""
    _tp2_prints_the_tp0_tokens("--arch", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("args,msg", [
    (("--tp", "2", "--cache-layout", "slots"), "--tp requires --cache-layout paged"),
    (("--tp", "2", "--engine", "scan"), "--tp serves through the continuous engine"),
])
def test_launcher_tp_refusals(args, msg):
    r = _launch(*args)
    assert r.returncode != 0 and msg in r.stderr


def test_launcher_tp_refuses_more_ranks_than_cards(monkeypatch):
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--tp 2 > 1 visible CUDA devices"):
        launch_serve.main(["--reduced", "--tp", "2"])

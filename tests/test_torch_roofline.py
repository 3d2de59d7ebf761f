"""The port's roofline (``launch/roofline.py``), cost counting and dry run
(``launch/dryrun.py``) and the kernels' ``meta`` branches.

Against the JAX package: ``roofline_terms`` on JAX's test inputs with
JAX's constants set to the port's (bf16 peak, HBM, NVLink), and
``collective_wire_bytes`` on ``tests/test_roofline.py``'s HLO, record by
record.  Within the port: a count on the CPU equals one on ``meta`` of
the same reduced step; the two-point extrapolation in depth equals a full
count; counted product FLOPs equal 2*M*N*K summed over a forward; K1's
calls equal ``k1_per_pass`` / ``k1_per_train_step`` for every arch at
reduced width; the meta branches give the right shapes and dtypes and
launch nothing.
"""
import dataclasses
import json

import pytest
import torch

import repro.launch.roofline as JR
from repro_torch.configs import SHAPES, get_config, list_archs, reduced_config
from repro_torch.core.approx import ApproxConfig
from repro_torch.kernels.approx_matmul import approx_matmul
from repro_torch.kernels.approx_mul_eltwise import approx_mul_eltwise
from repro_torch.kernels.paged_attention import PagedAttentionShapeError, paged_attention
from repro_torch.kernels.work import k2_work
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.models.transformer import (
    forward,
    init_paged_cache,
    init_params,
    paged_decode_step,
)
from repro_torch.serve.engine import freeze_params
from repro_torch.train import optim as O
from repro_torch.train.loop import init_state, make_train_step

H100 = "NVIDIA H100 80GB HBM3"
RATES = R.CARDS[H100]
TINY = {"train": dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=2),
        "prefill": dataclasses.replace(SHAPES["prefill_32k"], seq_len=16, global_batch=2),
        "decode": dataclasses.replace(SHAPES["decode_32k"], seq_len=16, global_batch=2)}

HLO = open(__file__.replace("test_torch_roofline.py", "test_roofline.py")).read().split(
    'HLO = """', 1)[1].split('"""', 1)[0]


@pytest.fixture
def jax_rates(monkeypatch):
    monkeypatch.setattr(JR, "PEAK_FLOPS", RATES.bfloat16)
    monkeypatch.setattr(JR, "HBM_BW", RATES.hbm)
    monkeypatch.setattr(JR, "LINK_BW", RATES.link)


def test_h100_rates():
    assert (RATES.bfloat16, RATES.tf32, RATES.float32, RATES.int8) == (
        989.4e12, 494.7e12, 67e12, 1978.9e12)
    assert (RATES.hbm, RATES.link) == (3.35e12, 450e9)
    assert (R.HBM_BYTES_PER_S, R.INT8_OPS_PER_S, R.F32_FLOPS_PER_S) == (3.35e12, 1978.9e12, 67e12)


def test_unknown_card_raises():
    with pytest.raises(R.UnknownCardError, match="Tesla K80"):
        R.card_rates("Tesla K80")
    with pytest.raises(R.UnknownCardError):
        R.roofline_terms(flops_per_device=1.0, bytes_per_device=1.0, wire_bytes_per_device=0.0,
                         n_devices=1, card="NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("inputs", [
    dict(flops_per_device=1.97e14, bytes_per_device=8.19e10, wire_bytes_per_device=5e9,
         n_devices=256, model_flops_global=1.97e14 * 256 / 2),
    dict(flops_per_device=1e12, bytes_per_device=1e12, wire_bytes_per_device=0,
         n_devices=4, model_flops_global=4e12),
    dict(flops_per_device=1e9, bytes_per_device=1e3, wire_bytes_per_device=1e12, n_devices=8),
])
def test_roofline_terms_equal_jax(jax_rates, inputs):
    want = JR.roofline_terms(**inputs)
    got = R.roofline_terms(**inputs, card=H100)
    assert set(want) <= set(got)
    for k, v in want.items():
        assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-12)), k


def test_roofline_dominance_and_fraction():
    """JAX's assertions, at the H100's rates."""
    t = R.roofline_terms(flops_per_device=RATES.bfloat16, bytes_per_device=RATES.hbm / 10,
                         wire_bytes_per_device=RATES.link / 10, n_devices=256,
                         model_flops_global=RATES.bfloat16 * 256 / 2, card=H100)
    assert t["bound"] == "compute"
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["useful_flop_fraction"] == pytest.approx(0.5)
    assert t["roofline_fraction"] == pytest.approx(0.5)
    t = R.roofline_terms(flops_per_device=1e12, bytes_per_device=1e12, wire_bytes_per_device=0,
                         n_devices=4, model_flops_global=4e12, card=H100)
    assert t["bound"] == "memory"
    assert t["roofline_fraction"] == pytest.approx(
        (4e12 / (1e12 / RATES.hbm)) / 4 / RATES.bfloat16)


def test_compute_term_by_class(monkeypatch):
    by = {"float32": RATES.float32, "int8": RATES.int8, "bfloat16": RATES.bfloat16}
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    t = R.roofline_terms(flops_per_device=by, bytes_per_device=0.0, wire_bytes_per_device=0.0,
                         n_devices=1, card=H100)
    assert t["t_compute_s"] == pytest.approx(3.0)
    assert t["flops_by_class"] == by
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    t = R.roofline_terms(flops_per_device=by, bytes_per_device=0.0, wire_bytes_per_device=0.0,
                         n_devices=1, card=H100)
    assert t["t_compute_s"] == pytest.approx(2.0 + RATES.float32 / RATES.tf32)
    with pytest.raises(ValueError, match="int32"):
        R.roofline_terms(flops_per_device={"int32": 1.0}, bytes_per_device=0.0,
                         wire_bytes_per_device=0.0, n_devices=1, card=H100)


def test_collective_wire_bytes_equal_parse_collectives():
    records = 0
    for line in HLO.splitlines():
        st = JR.parse_collectives(line)
        ops = [op for op, c in st.counts.items() if c]
        hit = next((op for op in JR._COLL_OPS if f" {op}(" in line), None)
        if hit is None:
            continue
        seg = line.split("=", 1)[1].split(f" {hit}", 1)[0]
        got = R.collective_wire_bytes(hit, JR._shape_bytes(seg), JR._group_size(line))
        assert got == pytest.approx(st.per_op[hit]), line
        assert ops in ([hit], [])
        records += 1
    assert records == 4
    assert R.collective_wire_bytes("all-reduce", 100.0, 1) == 0.0
    with pytest.raises(ValueError):
        R.collective_wire_bytes("broadcast", 1.0, 2)


def test_bounds_of_phases_two_and_three():
    """chip_smoke.py's K1 decode-step bound (bytes) and K2's f32 step."""
    ms, by = R.bound(1e9, 1e9, R.INT8_OPS_PER_S)
    assert (ms, by) == (pytest.approx(1e9 / 3.35e12 * 1e3), "bytes")
    ms, by = R.k2_bound(4, 32, 8, 64, 10, 400, 2, 4, calls=40)
    nbytes = 40 * (4 * (2 * 32 * 64 * 2 + 2 * 8 * 64 * 4 + 4 * 11) + 2 * 4 * 400 * 8 * 64)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------


def test_meta_branches_shapes_and_no_launch():
    n0 = (approx_matmul.launches, paged_attention.launches, approx_mul_eltwise.launches)
    m = torch.device("meta")
    a = torch.empty((3, 5, 70), dtype=torch.uint8, device=m)
    b = torch.empty((70, 33), dtype=torch.uint8, device=m)
    out = approx_matmul(a, b, multiplier="mul8x8_2")
    assert (out.shape, out.dtype, out.device.type) == ((3, 5, 33), torch.int32, "meta")
    for qd, pd in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        q = torch.empty((4, 8, 64), dtype=qd, device=m)
        kn = torch.empty((4, 2, 64), dtype=pd, device=m)
        pool = torch.empty((11, 16, 2, 64), dtype=pd, device=m)
        tbl = torch.empty((4, 5), dtype=torch.int32, device=m)
        cl = torch.empty((4,), dtype=torch.int32, device=m)
        out = paged_attention(q, kn, kn, pool, pool, tbl, cl, block_size=16)
        assert (out.shape, out.dtype, out.device.type) == ((4, 8, 64), qd, "meta")
    with pytest.raises(PagedAttentionShapeError):     # what the kernel refuses, refused
        paged_attention(torch.empty((4, 8, 62), device=m), torch.empty((4, 2, 62), device=m),
                        torch.empty((4, 2, 62), device=m), torch.empty((11, 16, 2, 62), device=m),
                        torch.empty((11, 16, 2, 62), device=m), tbl, cl, block_size=16)
    x = torch.empty((7, 9), dtype=torch.int32, device=m)
    out = approx_mul_eltwise(x, x, multiplier="mul8x8_1")
    assert (out.shape, out.dtype, out.device.type) == ((7, 9), torch.int32, "meta")
    assert (approx_matmul.launches, paged_attention.launches,
            approx_mul_eltwise.launches) == n0
    with pytest.raises(ValueError, match="meta"):
        approx_matmul(a, torch.zeros((70, 33), dtype=torch.uint8))
    with pytest.raises(ValueError):
        approx_mul_eltwise(x, torch.zeros((7, 9), dtype=torch.int32))


def test_kernel_work_reported():
    m = torch.device("meta")
    a = torch.empty((6, 70), dtype=torch.uint8, device=m)
    b = torch.empty((70, 33), dtype=torch.uint8, device=m)
    c = R.count_costs(lambda: [approx_matmul(a, b), approx_mul_eltwise(a, a)])
    k1, k3 = c.kernels["approx_matmul"], c.kernels["approx_mul_eltwise"]
    assert (k1["calls"], k1["ops"], k1["bytes"], k1["op_class"]) == (
        1, 2.0 * 6 * 33 * 70, 6 * 70 + 70 * 33 + 4 * 6 * 33, "int8")
    assert k1["design_ops"] > k1["ops"]
    assert (k3["calls"], k3["bytes"], k3["ops"]) == (1, 6.0 * 6 * 70, 0.0)
    assert c.peak_bytes == 4 * 6 * 33 + 4 * 6 * 70       # both results, alive at once


# ---------------------------------------------------------------------------
# counting steps
# ---------------------------------------------------------------------------


def _cfg(arch="granite-3-2b", mode="kernel", **kw):
    return dataclasses.replace(reduced_config(get_config(arch), **kw),
                               approx=ApproxConfig(mode=mode))


def _materialize(tree, dev, gen):
    """A meta tree's real twin on ``dev``: integers in [0, 8), floats normal."""
    if isinstance(tree, dict):
        return {k: _materialize(v, dev, gen) for k, v in tree.items()}
    if tree.dtype in (torch.int32, torch.int64):
        return torch.randint(0, 8, tree.shape, generator=gen, dtype=tree.dtype).to(dev)
    return torch.randn(tree.shape, generator=gen).to(tree.dtype).to(dev)


def _steps(cfg, dev):
    """(name, fn, args, grad) of a training step, a prefill and a slot
    and a paged decode step of ``cfg`` on ``dev``."""
    gen = torch.Generator().manual_seed(0)
    opt = O.OptConfig()
    out = [("train", make_train_step(cfg, opt), (
        init_state(cfg, opt, 0, device=dev),
        _materialize(S.input_specs(cfg, TINY["train"]), dev, gen)), True)]
    params = freeze_params(cfg, init_params(cfg, 0, device=dev))
    out.append(("prefill", D._prefill(cfg), (
        params, _materialize(S.input_specs(cfg, TINY["prefill"]), dev, gen)), False))
    cache = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in S.cache_specs(cfg, TINY["decode"]).items()}
    out.append(("decode", D._decode(cfg), (
        params, cache, _materialize(S.input_specs(cfg, TINY["decode"]), dev, gen),
        torch.full((2,), 5, dtype=torch.int32, device=dev)), False))
    pool = init_paged_cache(cfg, 8, 4, device=dev)
    tables = torch.tensor([[0, 1, 8], [2, 3, 4]], dtype=torch.int32, device=dev)
    out.append(("paged", lambda p, c, t, cl, tb: paged_decode_step(
        cfg, p, c, t, cl, tb, block_size=4), (
        params, pool, torch.zeros((2, 1), dtype=torch.int32, device=dev),
        torch.tensor([6, 9], dtype=torch.int32, device=dev), tables), False))
    return out


def _count_warm(fn, args, grad):
    with torch.set_grad_enabled(grad):
        fn(*args)                   # the first call also fills the port's host caches
        return R.count_costs(fn, *args)


def test_cpu_count_equals_meta_count():
    """Equal counts, live bytes after every operation included, but for
    K2's work: on the CPU the positions the table and lengths hold (rows
    of 6 and 9 positions, the first row's third entry the sentinel), on
    meta every table entry's (2 rows x 3 blocks x 4), an upper bound."""
    cfg = _cfg(remat=True)
    cpu = {n: _count_warm(f, a, g) for n, f, a, g in _steps(cfg, "cpu")}
    meta = {n: _count_warm(f, a, g) for n, f, a, g in _steps(cfg, "meta")}
    k2 = {dev: c["paged"].kernels.pop("paged_attention") for dev, c in (("cpu", cpu),
                                                                          ("meta", meta))}
    for name in cpu:
        assert cpu[name] == meta[name], name
        assert cpu[name].trace == meta[name].trace, name
        assert cpu[name].kernels["approx_matmul"]["calls"] > 0
    assert k2["cpu"]["calls"] == k2["meta"]["calls"] == cfg.num_layers
    H, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for dev, valid in (("cpu", 6 + 4 + 4 + 1), ("meta", 2 * 3 * 4)):
        w = k2_work(2, H, hkv, hd, 3, valid, 4, 4)
        assert (k2[dev]["bytes"], k2[dev]["ops"]) == (
            cfg.num_layers * w.bytes, cfg.num_layers * w.ops), dev
    assert cpu["train"].flops["float32"] > 0 and cpu["train"].peak_bytes > 0


def test_counted_products_equal_2mnk():
    cfg = _cfg(mode="float")
    B, T = 2, 16
    params = init_params(cfg, 0, device="meta")
    toks = torch.empty((B, T), dtype=torch.int32, device="meta")
    with torch.no_grad():
        c = R.count_costs(forward, cfg, params, toks)
    d, hq, hkv, ff = cfg.d_model, cfg.num_heads * cfg.head_dim, \
        cfg.num_kv_heads * cfg.head_dim, cfg.d_ff
    M = B * T
    proj = 2 * M * (d * hq + 2 * d * hkv + hq * d + 3 * d * ff)
    attn = 2 * (2 * B * cfg.num_heads * T * T * cfg.head_dim)
    want = cfg.num_layers * (proj + attn) + 2 * M * d * cfg.padded_vocab
    assert c.flops == {"float32": want}
    # through K1: the projections' products are K1's, the attention's stay
    q = _cfg(mode="kernel")
    with torch.no_grad():
        c = R.count_costs(forward, q, freeze_params(q, init_params(q, 0, device="meta")), toks)
    assert c.flops == {"float32": cfg.num_layers * attn}
    assert c.kernels["approx_matmul"]["ops"] == cfg.num_layers * proj + 2 * M * d * q.padded_vocab


@pytest.mark.parametrize("arch,layers", [("granite-3-2b", 4), ("granite-3-2b", 12),
                                         ("qwen2-moe-a2.7b", 3), ("zamba2-2.7b", 8),
                                         ("falcon-mamba-7b", 3), ("falcon-mamba-7b", 12)])
def test_two_point_extrapolation_equals_full_count(arch, layers):
    """Counts from 1 and 2 layer units equal a full count, the peak of
    live storages included; at 12 layers the training step's peak has
    moved to the end of its backward (the line through 1 and 2 layers
    alone misses it by 28-31%)."""
    cfg = dataclasses.replace(_cfg(arch, remat=True), num_layers=layers)
    opt = O.OptConfig()
    for kind, shape in TINY.items():
        got = D.extract_costs(cfg, shape, opt)
        assert got["microbatches"] == 1
        fn, args, grad = D.build_step(cfg, shape, opt)
        with torch.set_grad_enabled(grad):
            want = R.count_costs(fn, *args)
        tot = got["total"]
        for cls, f in want.flops.items():
            assert tot.flops[cls] == pytest.approx(f, rel=1e-12), (kind, cls)
        assert (tot.bytes, tot.bytes_raw) == (pytest.approx(want.bytes, rel=1e-12),
                                              pytest.approx(want.bytes_raw, rel=1e-12)), kind
        assert tot.n_ops == want.n_ops, kind
        for name, k in want.kernels.items():
            assert tot.kernels[name]["calls"] == k["calls"], (kind, name)
            assert tot.kernels[name]["bytes"] == pytest.approx(k["bytes"], rel=1e-12)
        assert tot.peak_bytes == want.peak_bytes, kind


@pytest.mark.parametrize("arch", list_archs())
def test_k1_calls_equal_predictors(arch):
    """K1's counted calls in a forward, a decode step and a training step
    (remat on) at reduced width: the predictors chip_smoke.py holds the
    card to."""
    cfg = _cfg(arch, remat=True)
    opt = O.OptConfig()
    for kind, shape in TINY.items():
        fn, args, grad = D.build_step(cfg, shape, opt)
        with torch.set_grad_enabled(grad):
            c = R.count_costs(fn, *args)
        want = D.k1_per_train_step(cfg) if kind == "train" else D.k1_per_pass(cfg)
        assert c.kernels["approx_matmul"]["calls"] == want, kind
    cfg_nr = dataclasses.replace(cfg, remat=False)
    fn, args, _ = D.build_step(cfg_nr, TINY["train"], opt)
    assert R.count_costs(fn, *args).kernels["approx_matmul"]["calls"] == D.k1_per_pass(cfg)


def test_run_cell():
    """granite-3-2b's train and decode cells end to end on meta (full
    width, about 2 s), as the CLI writes them."""
    n0 = approx_matmul.launches
    cfg = get_config("granite-3-2b")
    for shape in ("train_4k", "decode_32k", "long_500k"):
        res = D.run_cell("granite-3-2b", shape)
        if shape == "long_500k":
            assert "skipped" in res
            continue
        per = D.k1_per_train_step(cfg) * 64 if shape == "train_4k" else D.k1_per_pass(cfg)
        assert res["microbatches"] == (64 if shape == "train_4k" else 1)
        assert res["kernels"]["approx_matmul"]["calls"] == per
        assert res["t_bound_s"] > 0 and res["temp_size_in_bytes"] > 0
        assert res["argument_size_in_bytes"] > 0
        assert (res["approx_mode"], res["multiplier"]) == ("kernel", "mul8x8_2")
        for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bound", "hlo_flops_global",
                  "useful_flop_fraction", "model_flops_per_s", "roofline_fraction", "count_s"):
            assert k in res, k
    assert approx_matmul.launches == n0


def test_in_depth_peak_rules():
    cfg = _cfg(num_layers=3)
    count = lambda c: D._count(c, TINY["decode"], O.OptConfig())
    with pytest.raises(ValueError, match="peak"):
        D.in_depth(cfg, count, peak="deep")
    c1, c2 = (count(dataclasses.replace(cfg, num_layers=k)) for k in (1, 2))
    line = c1.peak_bytes + 2 * (c2.peak_bytes - c1.peak_bytes)
    assert D.in_depth(cfg, count, peak="flat")["total"].peak_bytes == c2.peak_bytes
    assert D.in_depth(cfg, count, peak="grows")["total"].peak_bytes == line
    assert D.in_depth(cfg, count, peak="backward")["total"].peak_bytes == max(
        line, round(D.backward_peak(c1, c2, 3)))


def test_cli(tmp_path, capsys):
    assert D.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "granite-3-2b__decode_32k.json").read_text())
    assert res["kernels"]["approx_matmul"]["calls"] == D.k1_per_pass(get_config("granite-3-2b"))
    assert "decode_32k on NVIDIA H100 80GB HBM3: memory-bound" in capsys.readouterr().out
    for argv in (["--arch", "granite-3-2b"], ["--all", "--shape", "train_4k"], []):
        with pytest.raises(SystemExit):
            D.main(argv)


def test_cell_supported_and_microbatch():
    g, f = get_config("granite-3-2b"), get_config("falcon-mamba-7b")
    assert D.cell_supported(g, SHAPES["long_500k"]) is not None
    assert D.cell_supported(f, SHAPES["long_500k"]) is None
    assert D.cell_supported(g, SHAPES["train_4k"]) is None
    # 40 layers x 4096 x 2048 x 2 bytes per sequence: 5 fit in 4 GB
    assert D.auto_microbatch(g, SHAPES["train_4k"]) == 64
    assert D.auto_microbatch(g, SHAPES["train_4k"], dp=16) == 4
    n, tokens, mf = D.model_flops(g, SHAPES["train_4k"])
    assert (n, tokens, mf) == (g.param_count(), 256 * 4096, 6.0 * g.param_count() * 256 * 4096)
    moe = get_config("qwen2-moe-a2.7b")
    assert D.model_flops(moe, SHAPES["decode_32k"])[0] == moe.active_param_count()

"""The port's side of the paper against the JAX package's: the synthetic
datasets and the sharded loader (identical arrays), the multiplier metrics,
the hardware cost model and the rows of Tables V-VII (identical numbers;
the timing column aside), the ``lut`` execution mode (bit-equal to
``lowrank`` and to the JAX LUT oracle), the examples and Table VIII's
protocol on the port's own init, at small sizes on the CPU."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import ablation_removal as jablation
from benchmarks import table_v as jtable_v
from benchmarks import table_vi_vii as jtable_vi_vii
from repro.configs.paper_cnns import CNN_SPECS as J_CNN_SPECS
from repro.core import approx as japprox
from repro.core import hwcost as jhw
from repro.core import metrics as jmetrics
from repro.core import multipliers as jmul
from repro.data.loader import ShardedTokenLoader as JLoader
from repro.data.synthetic import image_dataset as jimage_dataset
from repro.kernels.approx_matmul.ref import approx_matmul_ref, approx_mul_elementwise
from repro_torch.configs.paper_cnns import CNN_SPECS
from repro_torch.core import approx as tapprox
from repro_torch.core import hwcost as thw
from repro_torch.core import metrics as tmetrics
from repro_torch.core import multipliers as tmul
from repro_torch.data.loader import ShardedTokenLoader
from repro_torch.data.synthetic import image_dataset
from repro_torch.kernels.approx_matmul import approx_matmul_lut
from repro_torch.kernels.approx_matmul import approx_mul_elementwise as t_elementwise
from repro_torch.paper import ablation_removal, kernel_bench, table_v, table_vi_vii, table_viii


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's thread pool spinning on cores that other workers hold slows
    these CPU-heavy tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cnn_specs_are_the_reference_specs():
    assert {k: dataclasses.astuple(v) for k, v in CNN_SPECS.items()} == {
        k: dataclasses.astuple(v) for k, v in J_CNN_SPECS.items()}


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_image_dataset_equals_jax(dataset):
    kw = dict(n_train=64, n_test=32, seed=3)
    want, got = jimage_dataset(dataset, **kw), image_dataset(dataset, **kw)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_hosts,host_id", [(1, 0), (4, 0), (4, 3)])
def test_sharded_loader_equals_jax(num_hosts, host_id):
    kw = dict(vocab=97, global_batch=8, seq_len=12, num_hosts=num_hosts, host_id=host_id, seed=5)
    want, got = JLoader(**kw), ShardedTokenLoader(**kw)
    assert got.host_batch == want.host_batch
    for step, (a, b) in zip(range(3), zip(want, got)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(got.batch_at(step)["tokens"], b["tokens"])


def test_sharded_loader_rejects_bad_slices():
    with pytest.raises(ValueError):
        ShardedTokenLoader(vocab=9, global_batch=6, seq_len=4, num_hosts=4)
    with pytest.raises(ValueError):
        ShardedTokenLoader(vocab=9, global_batch=8, seq_len=4, num_hosts=4, host_id=4)


def test_multiplier_metrics_equal_jax():
    tables = {"mul3x3_1": tmul.mul3x3_1_table(), "mul3x3_2": tmul.mul3x3_2_table()}
    tables.update({n: tmul.mul8x8_table(n) for n in tmul.MULTIPLIERS})
    for name, t in tables.items():
        got, want = tmetrics.multiplier_metrics(t, name), jmetrics.multiplier_metrics(t, name)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.as_dict() == want.as_dict()
    assert tmetrics.dal(0.9, 0.85) == jmetrics.dal(0.9, 0.85)


def _rows(table):
    return {k: dataclasses.astuple(v) for k, v in table.items()}


def test_hwcost_equals_jax():
    assert _rows(thw.PAPER_TABLE_VI) == _rows(jhw.PAPER_TABLE_VI)
    assert _rows(thw.PAPER_TABLE_VII) == _rows(jhw.PAPER_TABLE_VII)
    assert _rows(thw.COST_TABLE) == _rows(jhw.COST_TABLE)
    names = ("exact3x3", "mul3x3_1", "mul3x3_2", "exact8x8", "exact", "mul8x8_1", "mul8x8_2",
             "mul8x8_3", "pkm", "etm", "mul8x8_msr2", "mul8x8_msr4", "mul8x8_msr6")
    for n in names:
        assert thw.unit_gate_estimate(n) == jhw.unit_gate_estimate(n), n
    for n in jmul.MULTIPLIERS + ("exact8x8",):
        assert dataclasses.astuple(thw.mac_cost(n)) == dataclasses.astuple(jhw.mac_cost(n))
        assert thw.systolic_array_cost(n, rows=64, cols=32) == jhw.systolic_array_cost(
            n, rows=64, cols=32)
    assert thw.PAPER_TABLE_VII["pkm"].improvement_over(thw.PAPER_TABLE_VII["exact8x8"]) == \
        jhw.PAPER_TABLE_VII["pkm"].improvement_over(jhw.PAPER_TABLE_VII["exact8x8"])


@pytest.mark.parametrize("port,ref", [(table_v, jtable_v), (table_vi_vii, jtable_vi_vii),
                                      (ablation_removal, jablation)],
                         ids=["table_v", "table_vi_vii", "ablation_removal"])
def test_table_rows_equal_jax(port, ref):
    got, want = port.run(), ref.run()
    assert [(n, t) for n, _, t in got] == [(n, t) for n, _, t in want]
    assert all(us >= 0 for _, us, _ in got)


@pytest.mark.parametrize("multiplier", tmul.MULTIPLIERS)
def test_lut_mode_equals_lowrank_and_jax_oracle(multiplier):
    """``approx_matmul_lut`` (and the ``lut`` mode) equals the JAX oracle
    and the ``lowrank`` mode bit for bit, on a K that is a multiple of the
    512-chunk (the oracle's scanned path), a ragged one, and a leading batch
    axis; the row slicing of the gather changes nothing."""
    rng = np.random.default_rng(11)
    lut = tmul.mul8x8_table(multiplier)
    for lead, M, K, N in [((), 3, 1024, 5), ((2,), 4, 37, 19), ((), 5, 600, 3)]:
        a = rng.integers(0, 256, (*lead, M, K)).astype(np.uint8)
        b = rng.integers(0, 256, (K, N)).astype(np.uint8)
        want = np.asarray(approx_matmul_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lut)))
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = approx_matmul_lut(ta, tb, torch.from_numpy(lut))
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        for mode in ("lut", "lowrank"):
            cfg = tapprox.ApproxConfig(multiplier=multiplier, mode=mode)
            np.testing.assert_array_equal(tapprox.quantized_matmul(ta, tb, cfg).numpy(), want)
    x, y = rng.integers(0, 256, (7, 1)), rng.integers(0, 256, (1, 9))
    np.testing.assert_array_equal(
        t_elementwise(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(lut)).numpy(),
        np.asarray(approx_mul_elementwise(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lut))))


def test_lut_gather_row_slicing(monkeypatch):
    from repro_torch.kernels.approx_matmul import ref

    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.integers(0, 256, (9, 700)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (700, 6)).astype(np.uint8))
    lut = torch.from_numpy(tmul.mul8x8_table("pkm"))
    whole = approx_matmul_lut(a, b, lut)
    monkeypatch.setattr(ref, "_GATHER_ELEMS", 1000)            # 1 row per slice here
    np.testing.assert_array_equal(approx_matmul_lut(a, b, lut).numpy(), whole.numpy())


def test_lut_mode_dense_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    w = rng.normal(size=(40, 7)).astype(np.float32)
    for mult in ("mul8x8_3", "pkm"):
        want = np.asarray(japprox.approx_dense(jnp.asarray(x), jnp.asarray(w),
                                               japprox.ApproxConfig(multiplier=mult, mode="lut")))
        got = tapprox.approx_dense(torch.from_numpy(x), torch.from_numpy(w),
                                   tapprox.ApproxConfig(multiplier=mult, mode="lut"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    with pytest.raises(KeyError):
        japprox.ApproxConfig(multiplier="nope", mode="lut")
    with pytest.raises(KeyError):
        tapprox.ApproxConfig(multiplier="nope", mode="lut")


def test_kernel_bench_modes_agree_on_cpu():
    rows = kernel_bench.run(device="cpu", shape=(8, 600, 5), iters=1)
    names = [r[0] for r in rows]
    for mode in kernel_bench.MODES:
        assert f"kernel/{mode}_matmul_8x600x5" in names
    assert ("kernel/kernel_bitexact_vs_lut", 0.0, "equal=True") in rows
    assert ("kernel/lowrank_bitexact_vs_lut", 0.0, "equal=True") in rows
    assert all("on cpu" in t for n, _, t in rows if "matmul" in n)


def test_decode_bench_runs_on_cpu():
    rows = kernel_bench._decode_bench("cpu", batch=2, prompt_len=4, max_new=4, iters=1)
    assert [r[0] for r in rows] == ["serve/decode_legacy_loop_b2_n4",
                                    "serve/decode_scan_engine_b2_n4"]
    assert all(us > 0 and text.endswith("tok/s on cpu") for _, us, text in rows)


def test_approx_qat_lm_trains_and_resumes_on_cpu(tmp_path, capsys):
    """Two steps at the ``8m`` preset (batch and sequence cut), a checkpoint,
    then a second run resumes from it for one more step."""
    from repro_torch.examples import approx_qat_lm

    argv = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--ckpt", str(tmp_path / "ck")]
    first = approx_qat_lm.main(argv + ["--steps", "2"])
    assert first["start"] == 0 and len(first["losses"]) == 2
    assert all(np.isfinite(first["losses"]))
    again = approx_qat_lm.main(argv + ["--steps", "3"])
    assert again["start"] == 2 and len(again["losses"]) == 1 and np.isfinite(again["losses"][0])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--engine", "scan"], ["--engine", "legacy"],
                                  ["--engine", "continuous", "--cache-layout", "slots"]],
                         ids=["scan", "legacy", "continuous-slots"])
def test_serve_launcher_engines_on_cpu(argv, capsys):
    from repro_torch.launch import serve as launch

    out = launch.main(["--reduced", "--device", "cpu", "--exec", "approx", "--batch", "2",
                       "--new", "4", "--requests", "3"] + argv)
    text = capsys.readouterr().out
    if argv[1] == "continuous":
        assert len(out) == 3 and all(1 <= len(r.tokens) <= 4 for r in out.values())
        # the launcher's loop defaults to async, as the JAX launcher's does
        assert "/slots/async on cpu" in text and "attention impl gather" in text
    else:
        assert out.shape == (2, 8 + 4)
        assert f"[{argv[1]}/approx on cpu] generated 2x4 tokens" in text


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert out["lowrank_equal"] and out["kernel_equal"] and out["grad_finite"]
    assert out["rel_err_exact"] < out["rel_err_mul8x8_2"]
    assert "LUT-oracle == kernel" in capsys.readouterr().out


def test_lenet_example_checkpoints_and_restores_on_cpu(tmp_path, monkeypatch):
    """The example end to end on a tenth of its data (the plain versions of
    five multipliers on 512 test images take minutes on a busy CPU)."""
    from repro_torch.examples import lenet_mnist_qat

    monkeypatch.setattr(lenet_mnist_qat, "image_dataset",
                        lambda name, n_train, n_test, seed: image_dataset(
                            name, n_train=n_train // 10, n_test=n_test // 10, seed=seed))
    out = lenet_mnist_qat.main(["--device", "cpu", "--steps", "50", "--retrain-steps", "1",
                                "--ckpt", str(tmp_path / "ck")])
    assert out["restored_step"] == 50
    assert out["restored_acc"] == out["float_acc"]
    assert set(out["multipliers"]) == {"exact", "mul8x8_1", "mul8x8_2", "mul8x8_3", "pkm"}


def test_lenet_dal_and_cooptimization_port():
    """The JAX system test's claim on the port's own init and the CPU: LeNet
    learns the task, MUL8x8_2 costs little accuracy and no less than PKM
    (``tests/test_system.py::test_lenet_dal_and_cooptimization``)."""
    data = table_viii.on_device(image_dataset("mnist", n_train=1024, n_test=256, seed=0), "cpu")
    from repro_torch.models.cnn import init_cnn

    model = init_cnn("lenet", 0, in_shape=(28, 28, 1), device="cpu")
    fl = tapprox.ApproxConfig(mode="float")
    model = table_viii.train(model, data, fl, steps=80)
    acc_float = table_viii.accuracy(model, data, fl)
    assert acc_float > 0.8, acc_float
    acc_m2 = table_viii.accuracy(model, data, tapprox.ApproxConfig(multiplier="mul8x8_2",
                                                                   mode="kernel"))
    acc_pkm = table_viii.accuracy(model, data, tapprox.ApproxConfig(multiplier="pkm", mode="lut"))
    assert tmetrics.dal(acc_float, acc_m2) < 0.08, (acc_float, acc_m2)
    assert acc_m2 >= acc_pkm - 0.02


def test_table_viii_rows_on_cpu(monkeypatch):
    """``run`` gives the JAX benchmark's rows (names and text layout) with
    every multiplier's accuracy before and after retraining; the steps,
    data and multipliers are cut to keep the CPU run short."""
    assert table_viii.nets() == table_viii.nets(True)[:4]
    assert table_viii.nets(True)[4:] == [("alexnet", "cifar10"), ("vgg16", "cifar10"),
                                         ("resnet19", "cifar10")]
    monkeypatch.setattr(table_viii, "RETRAIN_STEPS", 1)
    monkeypatch.setattr(table_viii, "N_TRAIN", 128)
    monkeypatch.setattr(table_viii, "N_TEST", 32)
    monkeypatch.setattr(table_viii, "MULTIPLIERS", ("mul8x8_2", "pkm"))
    monkeypatch.setattr(table_viii, "nets", lambda full=False: [("lenet", "mnist")])
    real = table_viii.run_net
    monkeypatch.setattr(table_viii, "run_net",
                        lambda net, ds, *, steps, device=None: real(net, ds, steps=3,
                                                                    device=device))
    rows = table_viii.run(device="cpu")
    assert [r[0] for r in rows] == ["table_viii/lenet-mnist"]
    text = rows[0][2]
    assert text.startswith("exact=")
    for m in ("mul8x8_2", "pkm"):
        assert f"; {m}=" in text and "->retrain" in text



def test_paper_entry_points_raise_without_cuda(monkeypatch):
    """With no device asked for and no CUDA device, the slice's entry
    points raise instead of carrying on on the CPU."""
    from repro_torch.device import NoCudaDeviceError
    from repro_torch.examples import lenet_mnist_qat, quickstart
    from repro_torch.models.cnn import init_cnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_cnn("lenet", 0, in_shape=(28, 28, 1)),
                 lambda: table_viii.main([]), lambda: table_viii.run_net("lenet", "mnist", steps=1),
                 lambda: kernel_bench.main([]), lambda: quickstart.main([]),
                 lambda: lenet_mnist_qat.main(["--steps", "1"])):
        with pytest.raises(NoCudaDeviceError):
            call()


def test_slice_six_entry_points_raise_without_cuda(monkeypatch):
    """The decode bench, the LM QAT example and the launcher's batched
    engines, asked for no device and given no CUDA device, raise."""
    from repro_torch.device import NoCudaDeviceError
    from repro_torch.examples import approx_qat_lm
    from repro_torch.launch import serve as launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: kernel_bench._decode_bench(), lambda: approx_qat_lm.main(["--steps", "1"]),
                 lambda: launch.main(["--reduced", "--engine", "scan"]),
                 lambda: launch.main(["--reduced", "--engine", "legacy"])):
        with pytest.raises(NoCudaDeviceError):
            call()

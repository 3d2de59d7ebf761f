"""The port's slot-layout engine against the JAX package's: ``generate``,
``greedy_generate_legacy``, the fused prefill and ``decode_step``.

Greedy tokens are the contract: identical to JAX ``generate`` in every
execution mode (``approx`` is K1's plain version here, against the JAX
Pallas kernel in interpret mode), for both prefill modes and both
activation-scale settings, with frozen weights.  Caches are floats: the
fused-prefill cache equals the teacher-forced one to the JAX test's own
tolerance (1e-5, ``tests/test_engine.py``), and the port's equals the
JAX package's to the same.  Temperature sampling is held within the port
(its positional Philox schedule has no JAX twin).
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.serve import engine as jE
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    seed_cache,
)
from repro_torch.serve import (
    SamplingConfig,
    generate,
    greedy_generate,
    greedy_generate_legacy,
    prefill_step,
    serve_step,
)
from test_torch_serve import _models

PROMPT = np.asarray([[1, 2, 3, 4, 5], [40, 7, 300, 9, 11], [5, 5, 5, 5, 5]], np.int32)
CASES = [("exact", False)] + [(m, r) for m in ("exact_quant", "approx_lowrank", "approx")
                              for r in (False, True)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    PyTorch's thread pool spinning on cores that other workers hold slows
    the CPU-bound steps many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("prefill_mode", ["fused", "decode"])
@pytest.mark.parametrize("mode,per_row", CASES,
                         ids=[f"{m}-{'per_row' if r else 'per_tensor'}" for m, r in CASES])
def test_generate_greedy_tokens_match_jax(mode, per_row, prefill_mode):
    jcfg, jp, tcfg, tp = _models(mode, per_row)
    want = np.asarray(jE.generate(jcfg, jp, jnp.asarray(PROMPT), max_new=6,
                                  prefill_mode=prefill_mode))
    got = generate(tcfg, tp, PROMPT, max_new=6, prefill_mode=prefill_mode, device="cpu")
    assert got.shape == want.shape
    assert got.tolist() == want.tolist()


def _teacher_forced(cfg, params, prompt, cache):
    cur = torch.zeros((prompt.shape[0],), dtype=torch.long)
    last = None
    for i in range(prompt.shape[1]):
        last = decode_step(cfg, params, cache, prompt[:, i:i + 1], cur)
        cur = cur + 1
    return last


def test_fused_prefill_cache_matches_teacher_forced_and_jax():
    jcfg, jp, tcfg, tp = _models("exact")
    B, S0 = PROMPT.shape
    max_len = S0 + 4
    prompt = torch.from_numpy(PROMPT)
    logits, kvs = forward(tcfg, tp, prompt, return_kv=True)
    fused = init_cache(tcfg, B, max_len)
    seed_cache(tcfg, fused, kvs)
    tf = init_cache(tcfg, B, max_len)
    last = _teacher_forced(tcfg, tp, prompt, tf)

    jlogits, _, jkvs = jT.forward(jcfg, jp, {"tokens": jnp.asarray(PROMPT)}, return_kv=True)
    jfused = jT.seed_cache(jcfg, jT.init_cache(jcfg, B, max_len, jnp.float32), jkvs)
    for name in ("k", "v"):
        np.testing.assert_allclose(fused[name][:, :, :S0].numpy(), tf[name][:, :, :S0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(fused[name][:, :, :max_len].numpy(),
                                   np.asarray(jfused[name]), rtol=1e-5, atol=1e-5)
    assert not fused["k"][:, :, S0:].any() and not tf["k"][:, :, S0:].any()
    np.testing.assert_allclose(logits[:, -1].numpy(), last[:, 0].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_legacy_matches_generate_and_jax_legacy(mode):
    jcfg, jp, tcfg, tp = _models(mode)
    want = np.asarray(jE.greedy_generate_legacy(jcfg, jp, jnp.asarray(PROMPT), max_new=5))
    got = greedy_generate_legacy(tcfg, tp, PROMPT, max_new=5, device="cpu")
    assert got.tolist() == want.tolist()
    assert got.tolist() == generate(tcfg, tp, PROMPT, max_new=5, prefill_mode="decode",
                                    device="cpu").tolist()


def test_greedy_generate_wrapper_delegates_to_generate():
    _, _, tcfg, tp = _models("exact")
    a = greedy_generate(tcfg, tp, PROMPT, max_new=4, device="cpu")
    assert a.shape == (3, 5 + 4)
    assert a.tolist() == generate(tcfg, tp, PROMPT, max_new=4, device="cpu").tolist()


def test_eos_padding_matches_jax():
    jcfg, jp, tcfg, tp = _models("exact")
    base = generate(tcfg, tp, PROMPT, max_new=6, device="cpu")
    eos = int(base[0, 5 + 1])                      # row 0's second new token
    want = np.asarray(jE.generate(jcfg, jp, jnp.asarray(PROMPT), max_new=6,
                                  sampling=jE.SamplingConfig(eos_id=eos)))
    got = generate(tcfg, tp, PROMPT, max_new=6, sampling=SamplingConfig(eos_id=eos),
                   device="cpu")
    assert got.tolist() == want.tolist()
    row = got[0, 5:].numpy()
    hit = int(np.argmax(row == eos))
    assert (row[hit:] == eos).all() and got.shape == base.shape


def test_argument_checks_raise():
    _, _, tcfg, tp = _models("exact")
    with pytest.raises(ValueError, match="max_new must be >= 1"):
        generate(tcfg, tp, PROMPT, max_new=0, device="cpu")
    with pytest.raises(ValueError, match="max_len=8 < prompt_len"):
        generate(tcfg, tp, PROMPT, max_new=4, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="prefill_mode"):
        generate(tcfg, tp, PROMPT, prefill_mode="chunked", device="cpu")
    stub = types.SimpleNamespace(**{**vars(tcfg), "embed_input": False})
    with pytest.raises(ValueError, match="embed-input"):
        generate(stub, tp, PROMPT, device="cpu")
    ssm = types.SimpleNamespace(**{**vars(tcfg), "family": "ssm"})
    with pytest.raises(NotImplementedError, match="item 9"):
        init_cache(ssm, 1, 8)
    with pytest.raises(NotImplementedError, match="item 9"):
        decode_step(ssm, tp, {}, torch.zeros((1, 1), dtype=torch.long),
                    torch.zeros((1,), dtype=torch.long))


def test_temperature_is_deterministic_and_respects_top_k():
    _, _, tcfg, tp = _models("approx", per_row=True)
    samp = SamplingConfig(temperature=0.8, top_k=16)
    run = dict(max_new=6, sampling=samp, seed=3, prefill_mode="decode", device="cpu")
    a = generate(tcfg, tp, PROMPT, **run)
    assert a.tolist() == generate(tcfg, tp, PROMPT, **run).tolist()
    wide = SamplingConfig(temperature=5.0)
    assert generate(tcfg, tp, PROMPT, max_new=6, sampling=wide, seed=3,
                    device="cpu").tolist() != generate(tcfg, tp, PROMPT, max_new=6,
                                                       sampling=wide, seed=4,
                                                       device="cpu").tolist()
    # top_k = 1 leaves only the argmax: greedy, whatever the temperature
    one = generate(tcfg, tp, PROMPT, max_new=6, sampling=SamplingConfig(temperature=3.0, top_k=1),
                   seed=3, device="cpu")
    assert one.tolist() == generate(tcfg, tp, PROMPT, max_new=6, device="cpu").tolist()
    # every sampled token lies in its step's top 16: replay the sequence
    # through teacher-forced decode and check each token's rank
    cache = init_cache(tcfg, 3, 11)
    cur = torch.zeros((3,), dtype=torch.long)
    for i in range(10):
        logits = decode_step(tcfg, tp, cache, a[:, i:i + 1], cur)[:, 0]
        cur = cur + 1
        if i >= 4:
            top = torch.topk(logits, 16, dim=-1).indices
            assert (top == a[:, i + 1:i + 2]).any(-1).all(), i


def test_decode_step_past_max_len_drops_its_write_as_jax():
    """A row at cur_len == max_len: JAX's scatter drops the write and the
    row attends over the whole stripe.  The port writes its trash position
    and attends over the same stripe."""
    jcfg, jp, tcfg, tp = _models("exact")
    B, S0, max_len = 3, 5, 8
    rng = np.random.default_rng(0)
    kv = rng.normal(size=(tcfg.num_layers, B, max_len, tcfg.num_kv_heads,
                          tcfg.head_dim)).astype(np.float32)
    cur = np.asarray([max_len, S0, max_len - 1], np.int32)
    tok = PROMPT[:, :1]
    jlogits, jc = jT.decode_step(jcfg, jp, {"k": jnp.asarray(kv), "v": jnp.asarray(-kv)},
                                 {"tokens": jnp.asarray(tok)}, jnp.asarray(cur))
    tc = init_cache(tcfg, B, max_len)
    tc["k"][:, :, :max_len] = torch.from_numpy(kv)
    tc["v"][:, :, :max_len] = torch.from_numpy(-kv)
    tlogits = decode_step(tcfg, tp, tc, torch.from_numpy(tok), torch.from_numpy(cur))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, :, :max_len].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tc["k"][:, 0, :max_len].numpy(), kv[:, 0])  # dropped
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)


def test_prefill_and_serve_step_entry_points():
    jcfg, jp, tcfg, tp = _models("exact")
    prompt = torch.from_numpy(PROMPT)
    np.testing.assert_array_equal(prefill_step(tcfg, tp, prompt).numpy(),
                                  forward(tcfg, tp, prompt).numpy())
    cache = init_cache(tcfg, 3, 8)
    logits = serve_step(tcfg, tp, cache, prompt[:, :1], torch.zeros((3,), dtype=torch.long))
    assert logits.shape == (3, 1, tcfg.padded_vocab) and logits.dtype == torch.float32
    jlogits, _ = jE.serve_step(jcfg, jp, jT.init_cache(jcfg, 3, 8, jnp.float32),
                               {"tokens": jnp.asarray(PROMPT[:, :1])}, jnp.zeros((3,), jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    jax.block_until_ready(jlogits)


def test_engines_without_device_raise_without_cuda(monkeypatch):
    from repro_torch.device import NoCudaDeviceError

    _, _, tcfg, tp = _models("exact")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (generate, greedy_generate, greedy_generate_legacy):
        with pytest.raises(NoCudaDeviceError):
            fn(tcfg, tp, PROMPT, max_new=2)

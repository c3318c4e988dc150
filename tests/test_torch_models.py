"""Port parity: the language models at reduced size (qwen3-0.6b and
rwkv6-3b, ``reduced()``), weights carried across by ``interop.lm_params``.

The reference's model (``repro.models``) and the port's get the same
parameter pytree and the same numpy tokens or activations. Tolerances:
- one layer (``attention.forward``, ``rwkv6.time_mix``): 2e-2 abs and rel,
  about two bf16 ulps of outputs near 1. Both compute in bf16 with f32
  reductions; XLA's CPU backend expands bf16 activations (sigmoid, silu)
  into bf16 steps where PyTorch rounds once, an ulp apart, and the flash
  branch's P V is f32 in the port (the Pallas kernel's arithmetic) and bf16
  in the reference's XLA twin.
- whole models (logits after every layer, prefill, decode): 0.05
  relative and 0.05 of ``max(1, max|want|)`` absolute. 0.05 is the bound
  the reference holds its own decode to its forward (tests/test_models.py);
  across the two frameworks the per-layer ulps above flip bf16 roundings in
  about half of each layer's outputs (different f32 summation orders in
  the matmuls, the WKV and the norms) and compound over the layers, so the
  absolute part scales with the logits' range, as the kernel tests scale
  theirs. The port's own decode against its own forward keeps the plain
  0.05.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model, attention, blocks, rwkv6
from repro_torch.train import make_prefill_step

ARCHS = ["qwen3-0.6b", "rwkv6-3b"]
LAYER_TOL = 2e-2
MODEL_TOL = 0.05


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    return SimpleNamespace(jax=jax, jnp=jnp)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, jx):
    """(arch, reference config, model and params, the port's config and
    model with the same weights)."""
    from repro.configs import get_config as ref_get, reduced as ref_reduced
    from repro.models import Model as RefModel

    rcfg = ref_reduced(ref_get(request.param))
    rm = RefModel(rcfg, remat="none")
    rp = rm.init(jx.jax.random.PRNGKey(1))
    cfg = interop.arch_config(dataclasses.asdict(rcfg))
    m = Model(cfg, device="cpu")
    m.load_state_dict(interop.lm_params(
        cfg, jx.jax.tree.map(np.asarray, rp), device="cpu"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32)
    return SimpleNamespace(arch=request.param, rcfg=rcfg, rm=rm, rp=rp,
                           cfg=cfg, m=m, tokens=tokens)


def _close(got, want, tol, scaled=False):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if scaled else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _layer0(jx, pair):
    return jx.jax.tree.map(lambda a: a[0], pair.rp["stack"]["scan"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    from repro.configs import get_config as ref_get, reduced as ref_reduced

    for ref_cfg, cfg in ((ref_get(arch), get_config(arch)),
                         (ref_reduced(ref_get(arch)), reduced(get_config(arch)))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert interop.arch_config(dataclasses.asdict(ref_cfg)) == cfg
        assert cfg.total_params == ref_cfg.total_params


def test_unported_archs_and_blocks_raise():
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("recurrentgemma-2b")
    cfg = reduced(get_config("qwen3-0.6b"))
    for bad in (dataclasses.replace(cfg, block_pattern=("rec",)),
                dataclasses.replace(cfg, block_pattern=("attn", "local")),
                dataclasses.replace(cfg, frontend="vision")):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            Model(bad, device="cpu")


def test_layer_forward_matches_reference(jx, pair):
    """qwen3: attention.forward at s = 64 (plain branch) and 2048 (flash
    branch); rwkv6: time_mix at s = 96 (chunk 32) and 50 (chunk 25)."""
    from repro.models import attention as ref_attention, rwkv6 as ref_rwkv6

    layer, port_layer = _layer0(jx, pair), pair.m.layers[0]
    rng = np.random.default_rng(1)
    for s in ((64, 2048) if pair.arch.startswith("qwen") else (96, 50)):
        b = 1 if s == 2048 else 2
        x = rng.normal(size=(b, s, pair.cfg.d_model)).astype(np.float32)
        jx_in = jx.jnp.asarray(x, jx.jnp.bfloat16)
        t_in = torch.tensor(x).bfloat16()
        if pair.arch.startswith("qwen"):
            pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
            want = ref_attention.forward(layer["mix"], pair.rcfg, jx_in, pos)
            got = attention.forward(port_layer.mix, pair.cfg, t_in,
                                    torch.tensor(pos))
        else:
            want, _ = ref_rwkv6.time_mix(layer["rwkv"], pair.rcfg, jx_in)
            got = rwkv6.time_mix(port_layer.rwkv, pair.cfg, t_in)
        assert got.dtype == torch.bfloat16 and got.shape == (b, s, pair.cfg.d_model)
        _close(got, want, LAYER_TOL)


def test_forward_and_prefill_match_reference(jx, pair):
    from repro.train.steps import make_prefill_step as ref_prefill

    tokens = jx.jnp.asarray(pair.tokens)
    want, _ = jx.jax.jit(pair.rm.forward)(pair.rp, {"tokens": tokens})
    got = pair.m(torch.tensor(pair.tokens))
    assert got.shape == (2, 40, pair.cfg.vocab)
    _close(got, want, MODEL_TOL, scaled=True)
    want_last = jx.jax.jit(ref_prefill(pair.rm))(pair.rp, {"tokens": tokens})
    got_last = make_prefill_step(pair.m)(torch.tensor(pair.tokens))
    assert got_last.shape == (2, pair.cfg.vocab)
    _close(got_last, want_last, MODEL_TOL, scaled=True)


def test_decode_sequence_matches_reference(jx, pair):
    """16 decode steps from an empty cache, logits equal at every step;
    then the port's decode equals its own forward (teacher-forced)."""
    step = jx.jax.jit(pair.rm.decode_step)
    ref_cache = pair.rm.init_cache(2, 64)
    cache = pair.m.init_cache(2, 64)
    decoded = []
    for t in range(16):
        tok = pair.tokens[:, t]
        want, ref_cache = step(pair.rp, ref_cache, jx.jnp.asarray(tok),
                               jx.jnp.full((2,), t, jx.jnp.int32))
        got, cache = pair.m.decode_step(cache, torch.tensor(tok),
                                        torch.full((2,), t, dtype=torch.int32))
        _close(got, want, MODEL_TOL, scaled=True)
        decoded.append(got)
    full = pair.m(torch.tensor(pair.tokens[:, :16]))
    _close(torch.stack(decoded, dim=1), full.float().numpy(), MODEL_TOL)


def test_reset_cache_rows_empties_one_slot(pair):
    cache = pair.m.init_cache(2, 8)
    fresh = pair.m.init_cache(2, 8)
    tok = torch.tensor(pair.tokens[:, 0])
    for t in range(3):
        _, cache = pair.m.decode_step(cache, tok,
                                      torch.full((2,), t, dtype=torch.int32))
    blocks.reset_cache_rows(cache, 1)
    for layer, empty in zip(cache, fresh):
        for name in layer:
            assert torch.equal(layer[name][1], empty[name][1]), name
            assert not torch.equal(layer[name][0], empty[name][0]), name


def test_serve_main_answers_every_request(pair, capsys):
    out = serve.main(["--arch", pair.arch, "--reduced", "--device", "cpu",
                      "--batch", "3", "--cache-len", "16", "--requests", "5",
                      "--max-new", "4"])
    assert out["requests"] == 5 and out["tokens"] == 20
    assert sorted(out["produced"]) == list(range(5))
    assert all(len(toks) == 4 and all(0 <= x < pair.cfg.vocab for x in toks)
               for toks in out["produced"].values())
    assert "served 5 requests (20 tokens)" in capsys.readouterr().out

"""Port parity: the flash-attention and WKV kernels' plain versions.

The port's ``kernels.flash_attention.flash_attention`` and
``kernels.wkv_chunk.wkv_chunked`` run their plain PyTorch versions on CPU
tensors. They are held, on the same numpy inputs, to the reference's Pallas
kernels in interpret mode and to its oracles (``kernels/ref.py``), on the
shapes of tests/test_kernels.py plus a grouped-query case and a chunk that
shrinks. Tolerances are tests/test_kernels.py's: flash f32 2e-3, bf16 3e-2
(every sum in f32 in both, taken in another order; bf16 rounds the output);
WKV f32 2e-4, bf16 4e-2, scaled by ``max(1, max|want|)`` (the chunked
algebra against the sequential recurrence).

The tests marked ``cuda`` run each CUDA kernel against its plain version on
the card; they skip without one (``python -m pytest -m cuda
tests/test_torch_lm_kernels.py`` on a machine with one) and need no JAX.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import wkv_chunk as p_wkv
from repro_torch.models import flash as p_flash

FLASH_CASES = [(1, 256, 2, 64, True), (2, 128, 4, 32, True),
               (1, 256, 2, 64, False)]
WKV_CASES = [(1, 64, 2, 16, 16), (2, 96, 3, 32, 32), (1, 128, 2, 64, 64)]
TOLS = {"flash": {"f32": 2e-3, "bf16": 3e-2}, "wkv": {"f32": 2e-4, "bf16": 4e-2}}
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here rather than at the top so that the
    ``cuda`` tests also run on a machine without JAX."""
    import jax.numpy as jnp
    from repro.kernels import flash_attention, ref as kref, wkv_chunk
    from repro.models import flash

    return SimpleNamespace(jnp=jnp, fa=flash_attention, kref=kref,
                           wkv=wkv_chunk, flash=flash,
                           dtypes={"f32": jnp.float32, "bf16": jnp.bfloat16})


def _qkv(seed, b, s, h, hd, hk=None):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, hd)).astype(np.float32)
            for n in (h, hk or h, hk or h)]


def _wkv_inputs(shape):
    b, t, h, hd = shape[:4]
    rng = np.random.default_rng(hd)
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    lw = (-rng.uniform(0.01, 1.2, size=(b, t, h, hd))).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.3).astype(np.float32)
    return r, k, v, lw, u


def _close(got, want, tol, scale=1.0):
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               np.asarray(want, np.float32) / scale,
                               rtol=tol, atol=tol)


def _t(x, dtype, device="cpu"):
    return torch.tensor(x).to(device=device, dtype=dtype)


# ------------------------------- flash --------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_matches_pallas_and_oracle(ref, dtype):
    tol = TOLS["flash"][dtype]
    for i, (b, s, h, hd, causal) in enumerate(FLASH_CASES):
        q, k, v = _qkv(i, b, s, h, hd)
        jq, jk, jv = (ref.jnp.asarray(x, ref.dtypes[dtype]) for x in (q, k, v))
        # the port's inputs are the reference's, rounded alike
        tq, tk, tv = (torch.tensor(np.asarray(x.astype(ref.jnp.float32)))
                      .to(TORCH_DTYPES[dtype]) for x in (jq, jk, jv))
        got = p_fa.flash_attention(tq, tk, tv, causal=causal)
        assert got.dtype == TORCH_DTYPES[dtype] and got.shape == tq.shape
        got = got.float().numpy()
        pallas = ref.fa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                        block_kv=64, interpret=True)
        _close(got, pallas, tol)
        for bi in range(b):
            _close(got[bi], ref.kref.flash_attention_ref(
                jq[bi], jk[bi], jv[bi], causal=causal), tol)


def test_flash_plain_grouped_and_ragged(ref):
    """Grouped kv heads read in place == the oracle's repeated heads; a
    sequence that no tile divides."""
    for s in (128, 100):
        q, k, v = _qkv(7, 1, s, 4, 32, hk=2)
        got = p_fa.flash_attention(*(torch.tensor(x) for x in (q, k, v)))
        want = ref.kref.flash_attention_ref(q[0], k[0], v[0], causal=True)
        _close(got[0].numpy(), want, TOLS["flash"]["f32"])


def test_flash_attend_and_attend_reference(ref):
    """models.flash: the plain oracle equals the reference's; flash_attend
    (f32 P V, the Pallas kernel's arithmetic) equals the reference's XLA
    twin (bf16 P V) to bf16 rounding, 3e-2."""
    b, s, h, hd = 2, 256, 2, 32
    q, k, v = (ref.jnp.asarray(x, ref.jnp.bfloat16) for x in _qkv(3, b, s, h, hd))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    tq, tk, tv = (torch.tensor(np.asarray(x.astype(ref.jnp.float32)))
                  .bfloat16() for x in (q, k, v))
    tpos = torch.tensor(pos)
    _close(p_flash.attend_reference(tq, tk, tv, tpos, tpos).float(),
           ref.flash.attend_reference(q, k, v, pos, pos, None), 1e-2)
    want = ref.flash.flash_attend(q, k, v, pos, pos, None, 64)
    _close(p_flash.flash_attend(tq, tk, tv).float(), want, 3e-2)
    with pytest.raises(NotImplementedError, match="window"):
        p_flash.flash_attend(tq, tk, tv, window=32)


# -------------------------------- WKV ---------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_plain_matches_pallas_and_oracle(ref, dtype):
    tol = TOLS["wkv"][dtype]
    for shape in WKV_CASES + [(1, 50, 2, 16, 16)]:   # T = 50: chunk 16 -> 10
        r, k, v, lw, u = _wkv_inputs(shape)
        jr, jk, jv = (ref.jnp.asarray(x, ref.dtypes[dtype]) for x in (r, k, v))
        tr, tk, tv = (torch.tensor(np.asarray(x.astype(ref.jnp.float32)))
                      .to(TORCH_DTYPES[dtype]) for x in (jr, jk, jv))
        got = p_wkv.wkv_chunked(tr, tk, tv, torch.tensor(lw), torch.tensor(u),
                                chunk=shape[4])
        assert got.dtype == TORCH_DTYPES[dtype] and got.shape == tr.shape
        got = got.float().numpy()
        want = np.asarray(ref.kref.wkv_sequential_ref(jr, jk, jv, lw, u),
                          np.float32)
        scale = max(1.0, float(np.abs(want).max()))
        _close(got, want, tol, scale)
        _close(got, ref.wkv.wkv_chunked(jr, jk, jv, lw, u, chunk=shape[4],
                                        interpret=True), tol, scale)


def test_wkv_chunk_shrinks_as_the_reference():
    assert [p_wkv.chunk_len(t, 32) for t in (4096, 96, 50, 4095, 97, 7)] == [
        32, 32, 25, 21, 1, 7]


# ------------------------- the CUDA kernels (card) ---------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,hk,hd,causal", [
    (1, 256, 2, 2, 64, True), (2, 128, 4, 4, 32, True),
    (1, 256, 2, 2, 64, False), (2, 200, 8, 2, 128, True),
    (1, 77, 4, 1, 32, False), (1, 4096, 2, 1, 128, True)])
def test_cuda_flash_kernel_matches_plain_version(dtype, b, s, h, hk, hd,
                                                 causal):
    _need_card()
    q, k, v = (_t(x, TORCH_DTYPES[dtype], "cuda")
               for x in _qkv(s, b, s, h, hd, hk))
    before = p_fa.flash_attention.launches
    got = p_fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert p_fa.flash_attention.launches == before + 1
    want = p_fa.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = TOLS["flash"][dtype]
    _close(got.float().cpu(), want.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", WKV_CASES + [
    (2, 4095, 4, 64, 32), (1, 97, 3, 32, 32), (1, 256, 2, 64, 64)])
def test_cuda_wkv_kernel_matches_plain_version(dtype, shape):
    _need_card()
    r, k, v, lw, u = _wkv_inputs(shape)
    args = [_t(x, TORCH_DTYPES[dtype], "cuda") for x in (r, k, v)] + [
        _t(x, torch.float32, "cuda") for x in (lw, u)]
    before = p_wkv.wkv_chunked.launches
    got = p_wkv.wkv_chunked(*args, chunk=shape[4])
    torch.cuda.synchronize()
    assert p_wkv.wkv_chunked.launches == before + 1
    want = p_wkv.wkv_chunked_ref(*args, chunk=shape[4])
    assert got.dtype == want.dtype and got.shape == want.shape
    want = want.float().cpu()
    scale = max(1.0, float(want.abs().max()))
    _close(got.float().cpu(), want, TOLS["wkv"][dtype], scale)

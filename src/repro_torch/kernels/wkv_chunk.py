"""Chunked RWKV6 WKV: the wrapper of the Hopper kernel in
``csrc/wkv_chunk.cu`` (the port of the reference's
``kernels/wkv_chunk.py::wkv_chunked``) and its plain PyTorch version.

Both compute, per (batch, head), the recurrence
``S_t = diag(w_t) S_{t-1} + k_t v_t^T``,
``o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)`` chunk by chunk with the
reference's algebra (``models/rwkv6.py``), in f32, for r, k, v, logw
``[b, T, h, hd]`` (``logw <= 0``) and u ``[h, hd]``; o has r's shape and
dtype. The chunk is ``min(chunk, T)`` shrunk until it divides T, as the
reference's wrapper shrinks it (1 for a prime T). On a CPU tensor
:func:`wkv_chunked` runs :func:`wkv_chunked_ref`; on a CUDA tensor it
launches the kernel or raises. ``wkv_chunked.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: head widths the kernel is compiled for (reduced configs: 32; rwkv6: 64)
HEAD_DIMS = (16, 32, 64)
#: longest chunk the kernel's shared-memory tiles take
MAX_CHUNK = 64
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def chunk_len(t: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, t)`` shrunk until it divides t."""
    c = min(chunk, t)
    while t % c:
        c -= 1
    return c


def wkv_chunked_ref(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch version, on any device: every chunk's products as
    batched einsums, the state carried over chunks in a Python loop."""
    b, t, h, hd = r.shape
    c = chunk_len(t, chunk)
    nc = t // c
    rc, kc, vc, wc = (x.float().reshape(b, nc, c, h, hd)
                      for x in (r, k, v, logw))
    uf = u.float()
    bcum = torch.cumsum(wc, dim=2)                # inclusive
    bex = bcum - wc                               # exclusive (b_{t-1})
    btot = bcum[:, :, -1]                         # [b, nc, h, hd]
    qp = rc * torch.exp(bex - btot[:, :, None])
    kp = kc * torch.exp(btot[:, :, None] - bcum)
    scores = torch.einsum("bclhi,bcmhi->bchlm", qp, kp)
    strict = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    scores = scores.masked_fill(~strict, 0.0)
    o = torch.einsum("bchlm,bcmhv->bclhv", scores, vc)
    o = o + (rc * uf * kc).sum(-1, keepdim=True) * vc
    kpv = torch.einsum("bclhi,bclhv->bchiv", kp, vc)
    q_carry = rc * torch.exp(bex)
    decay = torch.exp(btot)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    carry = torch.empty_like(o)
    for ci in range(nc):
        carry[:, ci] = torch.einsum("blhi,bhiv->blhv", q_carry[:, ci], state)
        state = decay[:, ci, ..., None] * state + kpv[:, ci]
    return (o + carry).reshape(b, t, h, hd).to(r.dtype)


def wkv_chunked(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """The WKV output ``o [b, T, h, hd]``, ONE launch on CUDA tensors (r, k,
    v all f32 or all bf16, logw and u f32, contiguous, ``hd`` in
    ``HEAD_DIMS``, the chunk at most ``MAX_CHUNK``);
    :func:`wkv_chunked_ref` on CPU tensors."""
    if r.device.type == "cpu":
        return wkv_chunked_ref(r, k, v, logw, u, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv_chunked runs on CUDA or CPU tensors, got "
                         f"{r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be [b, T, h, hd], got {tuple(r.shape)}")
    b, t, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes f32 or bf16 r, k, v, got {r.dtype}")
    c = chunk_len(t, chunk) if t else 1
    if c > MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of at most {MAX_CHUNK}, "
                         f"got {c}")
    for name, x, dtype, shape in (
            ("k", k, r.dtype, r.shape), ("v", v, r.dtype, r.shape),
            ("logw", logw, torch.float32, r.shape),
            ("u", u, torch.float32, (h, hd)), ("r", r, r.dtype, r.shape)):
        if x.device != r.device or x.dtype != dtype or x.shape != shape:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on "
                             f"{r.device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.numel() >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")
    o = torch.empty_like(r)
    with torch.cuda.device(r.device):
        _build.call("wkv_chunk", _ARGTYPES,
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    u.data_ptr(), o.data_ptr(), b, t, h, hd, c,
                    int(r.dtype == torch.bfloat16),
                    torch.cuda.current_stream(r.device).cuda_stream)
    wkv_chunked.launches += 1
    return o


wkv_chunked.launches = 0

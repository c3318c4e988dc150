"""Forward flash attention: the wrapper of the Hopper kernel in
``csrc/flash_attention.cu`` (the port of the reference's
``kernels/flash_attention.py::flash_attention``) and its plain PyTorch
version.

Both compute ``o = softmax(q k^T * hd^-0.5, causal by index) v`` for q
``[b, s, h, hd]`` and k, v ``[b, s, hk, hd]`` with ``hk`` dividing ``h``
(grouped-query attention: q head ``j`` reads kv head ``j // (h // hk)``,
what the reference computes after repeating k and v to flat heads), in
f32 with the output in q's dtype. On a CPU tensor :func:`flash_attention`
runs :func:`flash_attention_ref`; on a CUDA tensor it launches the kernel
or raises. ``flash_attention.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -1e30  # the reference's masked logit: keeps softmax NaN-free
#: head widths the kernel is compiled for (reduced configs: 32; qwen3: 128)
HEAD_DIMS = (32, 64, 128)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_void_p])


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [b, s, h, hd] and k, v [b, s, hk, hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same b, s, hd; kv heads dividing q heads)")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version, on any device: the full ``[b, h, s, s]`` f32
    score matrix, masked with ``NEG`` (and its probabilities with 0, as the
    kernel does), one softmax, one product with v."""
    _check_shapes(q, k, v)
    hd = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kf) * hd ** -0.5
    if causal:
        s = q.shape[1]
        live = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~live, NEG)
        p = torch.softmax(logits, dim=-1).masked_fill(~live, 0.0)
    else:
        p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Forward attention of q ``[b, s, h, hd]`` over k, v ``[b, s, hk, hd]``,
    ONE launch on a CUDA tensor (f32 or bf16, contiguous, ``hd`` in
    ``HEAD_DIMS``); :func:`flash_attention_ref` on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    _check_shapes(q, k, v)
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes f32 or bf16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q {q.dtype} "
                             f"on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b * s * h * hd >= 2 ** 31:
        raise ValueError("the kernel takes fewer than 2**31 elements")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.call("flash_attention", _ARGTYPES,
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, s, h, k.shape[2], hd, int(q.dtype == torch.bfloat16),
                    int(causal), hd ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

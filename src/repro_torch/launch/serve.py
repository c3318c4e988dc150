"""Batched serving launcher: continuous decode with a request queue (the
port of the reference's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        [--reduced] [--batch 4] [--cache-len 256] [--requests 8] \\
        [--max-new 32] [--temperature 1.0] [--device cuda]

A fixed-size decode batch over a KV cache (or the RWKV state) with one
slot per request: a finished request frees its slot for the next queued
prompt (continuous batching). Weights are random, drawn from a seeded
``torch.Generator``; prompts are one token each, from numpy's
``default_rng(0)`` as in the reference; tokens are sampled from a second
seeded generator. Runs at the config's full width unless ``--reduced``
(the reference's flag is always on). A slot's cache rows are emptied when
it takes a request, so no recurrent state passes from one request to the
next.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, reduced as reduce_cfg
from ..models import Model, blocks
from ..train import make_serve_step


def main(argv=None) -> dict:
    """Serve ``--requests`` requests; prints a summary and returns
    ``{"requests", "tokens", "seconds", "tokens_per_s", "steps",
    "produced"}`` (``produced``: request id -> its sampled tokens)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = Model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))
    step = make_serve_step(model)

    b = args.batch
    cache = model.init_cache(b, args.cache_len)
    rng = np.random.default_rng(0)
    queue = list(rng.integers(0, cfg.vocab, size=(args.requests,)))
    sampler = torch.Generator(dev).manual_seed(7)
    slot_tokens = torch.zeros((b,), dtype=torch.int32, device=dev)
    slot_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    slot_remaining = np.zeros((b,), np.int64)
    slot_req = -np.ones((b,), np.int64)
    done = 0
    next_req = 0
    produced = {i: [] for i in range(args.requests)}

    t0 = time.perf_counter()
    n_steps = 0
    while done < args.requests:
        # fill free slots from the queue (continuous batching)
        for i in range(b):
            if slot_remaining[i] == 0 and next_req < len(queue):
                slot_tokens[i] = int(queue[next_req])
                slot_pos[i] = 0
                blocks.reset_cache_rows(cache, i)
                slot_remaining[i] = args.max_new
                slot_req[i] = next_req
                next_req += 1
        logits, cache = step(cache, slot_tokens, slot_pos)
        probs = torch.softmax(logits.float() / args.temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=sampler)[:, 0]
        slot_tokens = nxt.to(torch.int32)
        slot_pos = slot_pos + 1
        n_steps += 1
        host_next = nxt.cpu().numpy()   # waits for the step
        for i in range(b):
            if slot_remaining[i] > 0:
                produced[int(slot_req[i])].append(int(host_next[i]))
                slot_remaining[i] -= 1
                if slot_remaining[i] == 0:
                    done += 1
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in produced.values())
    print(f"served {args.requests} requests ({total} tokens) in {dt:.3f}s "
          f"({total / dt:.1f} tok/s, {n_steps} decode steps) on {dev}")
    print("request 0 tokens:", produced[0][:12])
    return {"requests": args.requests, "tokens": total, "seconds": dt,
            "tokens_per_s": total / dt, "steps": n_steps,
            "produced": produced}


if __name__ == "__main__":
    main()

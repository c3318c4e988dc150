"""Carry the reference's state, as numpy, into the port.

For the miner, what crosses from the JAX package to the port is its data
and state: an event stream, a built type index, candidate rows and their
windows, the greedy ``(prev_end, prev_count)`` carries, and a miner
config, or a corpus of streams. For the language models it is an arch
config and a parameter pytree. Each function here takes numpy arrays (or
anything ``np.asarray`` reads) and returns the port's tensors or objects on
``device``: the card unless the caller asks for the CPU, as every entry
point of the port (``resolve_device`` raises without a card). Dtypes are
the ones the port computes in. Nothing here imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import resolve_device
from .configs.base import ArchConfig, MoECfg
from .core.events import EventStream
from .core.mining import MinerConfig

#: reference MinerConfig fields the port drops: settings of engines and
#: back ends that are not ported (the reference's interpret-mode switch and
#: the faithful engines' buffer sizes), whose values do not change what the
#: ported engines compute
_DROPPED = ("interpret", "cap_occ", "max_window")
#: reference MinerConfig fields of paths the port does not have yet: a
#: set value is rejected, the default is dropped
_UNPORTED = {"mesh": None, "shard_axis": "data", "n_shards": None,
             "halo": 256}


def _tensor(x, dtype, device) -> torch.Tensor:
    # a copy: arrays read from a jax array are not writable
    return torch.tensor(np.asarray(x, dtype), device=resolve_device(device))


def stream(types, times, n_types: int, device="cuda") -> EventStream:
    """An event stream ``(types i32[n], times f32[n], n_types)``."""
    return EventStream(
        _tensor(types, np.int32, device),
        _tensor(times, np.float32, device),
        int(n_types))


def corpus(streams: Sequence[Any], device="cuda") -> List[EventStream]:
    """A corpus: each stream given as an object with ``types``, ``times``
    and ``n_types`` (the reference's ``EventStream``) or as a
    ``(types, times, n_types)`` tuple."""
    out = []
    for s in streams:
        types, times, n_types = (
            s if isinstance(s, tuple) else (s.types, s.times, s.n_types))
        out.append(stream(types, times, n_types, device))
    return out


def type_index(table, counts, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """A built type index ``(table f32[n_types, cap], counts i32[n_types])``."""
    return (_tensor(table, np.float32, device),
            _tensor(counts, np.int32, device))


def candidates(symbols, t_low, t_high, device="cuda"):
    """Candidate rows and their windows: ``(symbols i32[B, N],
    t_low f32[B, N-1], t_high f32[B, N-1])``."""
    return (_tensor(symbols, np.int32, device),
            _tensor(t_low, np.float32, device),
            _tensor(t_high, np.float32, device))


def times_by_sym(times, device="cuda") -> torch.Tensor:
    """A gathered symbol-time table ``f32[..., N, cap]``."""
    return _tensor(times, np.float32, device)


def carries(prev_end, prev_count, device="cuda"):
    """The greedy chain state ``(prev_end f32[...], prev_count i32[...])``."""
    return (_tensor(prev_end, np.float32, device),
            _tensor(prev_count, np.int32, device))


def miner_config(fields: Dict[str, Any], device="cuda") -> MinerConfig:
    """The port's MinerConfig from ``dataclasses.asdict`` of the
    reference's, run on ``device``."""
    fields = dict(fields)
    for name in _DROPPED:
        fields.pop(name, None)
    for name, default in _UNPORTED.items():
        value = fields.pop(name, default)
        if value != default:
            raise NotImplementedError(
                f"MinerConfig.{name}={value!r}: that path is not ported yet")
    return MinerConfig(**fields, device=str(resolve_device(device)))


def arch_config(fields: Dict[str, Any]) -> ArchConfig:
    """The port's ArchConfig from ``dataclasses.asdict`` of the
    reference's."""
    fields = dict(fields)
    if isinstance(fields.get("moe"), dict):
        fields["moe"] = MoECfg(**fields["moe"])
    return ArchConfig(**fields)


def lm_params(cfg: ArchConfig, params: Dict[str, Any],
              device="cuda") -> Dict[str, torch.Tensor]:
    """The port ``Model``'s state dict (for ``load_state_dict``) from the
    reference's parameter pytree, given as nested dicts and lists of numpy
    arrays: ``stack.scan[pos]`` holds the layers ``pos, pos + P, ...`` of a
    ``P``-kind block pattern stacked on a leading axis, ``stack.tail`` the
    layers after the last whole pattern."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tree, index=None) -> None:
        if isinstance(tree, dict):
            for name, sub in tree.items():
                put(f"{prefix}.{name}", sub, index)
            return
        leaf = np.asarray(tree, np.float32)
        out[prefix] = torch.tensor(leaf if index is None else leaf[index],
                                   device=dev)

    for name in ("embed", "final_norm", "lm_head"):
        if name in params:
            put(name, params[name])
    period = len(cfg.block_pattern)
    n_super = cfg.n_layers // period
    for pos, stacked in enumerate(params["stack"]["scan"]):
        for i in range(n_super):
            put(f"layers.{i * period + pos}", stacked, i)
    for i, tail in enumerate(params["stack"]["tail"]):
        put(f"layers.{n_super * period + i}", tail)
    return out

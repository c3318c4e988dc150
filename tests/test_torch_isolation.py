"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, and the entry points run on the
card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop, resolve_device
from repro_torch.core import corpus, counting, mining
from repro_torch.core.episodes import episode_batch, serial
from repro_torch.core.events import EventStream
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_files_import_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_miner_loads_no_jax():
    code = ("import sys, repro_torch.core.mining, repro_torch.core.corpus, "
            "repro_torch.kernels.ops, repro_torch.interop, repro_torch.data, "
            "repro_torch.models.model, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.wkv_chunk; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = EventStream(np.array([0, 1, 0], np.int32),
                         np.array([0.0, 0.5, 1.0], np.float32), 2)
    cfg = mining.MinerConfig(t_low=0.0, t_high=1.0, threshold=1)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mining.mine_arrays(stream, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        counting.count_nonoverlapped(stream, serial([0, 1], 0.0, 1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus.mine_corpus([stream, stream], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        counting.count_corpus_indexed(
            np.full((1, 2, 4), np.inf, np.float32), np.zeros((1, 2), np.int32),
            np.zeros((1, 2), np.int32), np.zeros((1, 1), np.float32),
            np.ones((1, 1), np.float32), np.ones(1, np.int32))
    ep = serial([0, 1], 0.0, 1.0)
    for call in (lambda: ep.as_arrays(), lambda: episode_batch([ep]),
                 lambda: interop.stream([0], [0.0], 1),
                 lambda: interop.corpus([([0], [0.0], 1)]),
                 lambda: interop.times_by_sym(np.zeros((1, 2, 3))),
                 lambda: interop.miner_config(dict(t_low=0.0, t_high=1.0,
                                                   threshold=1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    cfg_lm = reduced(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg_lm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.lm_params(cfg_lm, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])
    # asked for, the CPU runs
    cfg.device = "cpu"
    assert mining.mine_arrays(stream, cfg)[2].counts.tolist() == [1, 1, 1]
    assert [r[2].counts.tolist() for r in corpus.mine_corpus(
        [stream, stream], cfg).per_stream] == [[1, 1, 1]] * 2
    assert Model(cfg_lm, device="cpu").embed.table.device.type == "cpu"

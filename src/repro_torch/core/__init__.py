"""Core of the port: non-overlapped counting of serial episodes with
inter-event constraints and level-wise mining, in PyTorch (kernels in
``repro_torch.kernels``)."""
from .episodes import Episode, serial, episode_batch, episodes_from_rows
from .events import EventStream, from_arrays, type_index, episode_symbol_times
from .counting import (CountResult, count_batch_dispatch, count_batch_indexed,
                       count_nonoverlapped, count_occurrences)
from .mining import (MinerConfig, LevelResult, LevelArrays, mine, mine_arrays,
                     generate_candidates, generate_candidates_arrays)
from .plan import MiningPlan, plan_for, capacity_class, pow2_ceil
from .tracking import (TrackingEngine, EngineConfig, register_engine,
                       get_engine, engine_names)
from .statemachine import count_fsm_numpy, greedy_numpy
from . import plan, scheduling, tracking

__all__ = [
    "Episode", "serial", "episode_batch", "episodes_from_rows",
    "EventStream", "from_arrays", "type_index", "episode_symbol_times",
    "CountResult", "count_batch_dispatch", "count_batch_indexed",
    "count_nonoverlapped", "count_occurrences",
    "MinerConfig", "LevelResult", "LevelArrays", "mine", "mine_arrays",
    "generate_candidates", "generate_candidates_arrays",
    "MiningPlan", "plan_for", "capacity_class", "pow2_ceil",
    "TrackingEngine", "EngineConfig", "register_engine", "get_engine",
    "engine_names", "count_fsm_numpy", "greedy_numpy",
    "plan", "scheduling", "tracking",
]

"""Core of the port: non-overlapped counting of serial episodes with
inter-event constraints and level-wise mining, in PyTorch (kernels in
``repro_torch.kernels``)."""
from .episodes import Episode, serial, episode_batch, episodes_from_rows
from .events import (EventStream, from_arrays, type_index, type_index_batch,
                     episode_symbol_times)
from .counting import (CountResult, count_batch_dispatch, count_batch_indexed,
                       count_corpus_indexed, count_nonoverlapped,
                       count_occurrences)
from .mining import (MinerConfig, LevelResult, LevelArrays, mine, mine_arrays,
                     generate_candidates, generate_candidates_arrays)
from .plan import MiningPlan, plan_for, capacity_class, pow2_ceil
from .corpus import (CorpusResult, aggregate_min_streams, mine_corpus,
                     pad_corpus, union_candidates)
from .tracking import (TrackingEngine, EngineConfig, register_engine,
                       get_engine, engine_names, track_batch_dispatch,
                       track_corpus_dispatch)
from .statemachine import count_fsm_numpy, greedy_numpy
from . import corpus, plan, scheduling, tracking

__all__ = [
    "Episode", "serial", "episode_batch", "episodes_from_rows",
    "EventStream", "from_arrays", "type_index", "type_index_batch",
    "episode_symbol_times",
    "CountResult", "count_batch_dispatch", "count_batch_indexed",
    "count_corpus_indexed", "count_nonoverlapped", "count_occurrences",
    "CorpusResult", "aggregate_min_streams", "mine_corpus", "pad_corpus",
    "union_candidates",
    "MinerConfig", "LevelResult", "LevelArrays", "mine", "mine_arrays",
    "generate_candidates", "generate_candidates_arrays",
    "MiningPlan", "plan_for", "capacity_class", "pow2_ceil",
    "TrackingEngine", "EngineConfig", "register_engine", "get_engine",
    "engine_names", "track_batch_dispatch", "track_corpus_dispatch", "count_fsm_numpy", "greedy_numpy",
    "corpus", "plan", "scheduling", "tracking",
]

from .spikes import (NetworkConfig, PAPER_DATASETS, embedded_episodes,
                     noise_pair_estimate, paper_dataset, simulate)

__all__ = ["NetworkConfig", "PAPER_DATASETS", "embedded_episodes",
           "noise_pair_estimate", "paper_dataset", "simulate"]

"""AdLoCo core of the port (the paper's contribution), with the JAX
package's module names:

  batching   — adaptive batch-size tests (norm / inner-product / augmented)
  diloco     — inner/outer step primitives
  mit        — trainer pool, CheckMerge / DoMerge
  switch     — SwitchMode execution planning
  adloco     — Algorithm 3 orchestrator
  local_sgd  — LocalSGD + vanilla-DiLoCo baselines
  comms      — communication metering (Theorem 2's C(N))
"""
from repro_torch.core import batching, comms, diloco, local_sgd, mit, switch
from repro_torch.core.adloco import (BatchPlanProtocol, History, RoundOutput,
                                     TrainerRound, train_adloco)
from repro_torch.core.local_sgd import (diloco_config, train_diloco,
                                        train_local_sgd)

__all__ = [
    "batching", "comms", "diloco", "local_sgd", "mit", "switch",
    "BatchPlanProtocol", "History", "RoundOutput", "TrainerRound",
    "train_adloco", "train_diloco", "train_local_sgd", "diloco_config",
]

"""L4 RL algorithms of the port: rollout, the minibatch update engine,
PPO. A2C and V-trace wait for their slices."""
from . import action_dist
from .ppo import (ClippedAdam, PPOConfig, PPOMetrics, TrainState,
                  compute_advantages, make_learn_step, make_optimizer,
                  make_train_state, make_train_step, normalize_advantages,
                  ppo_loss, run_ppo_epochs)
from .rollout import (RolloutCarry, Transition, init_carry, rollout,
                      validate_rollout_geometry)
from .update import (resolve_geometry, run_minibatch_epochs,
                     validate_update_geometry)

__all__ = [
    "action_dist", "ClippedAdam", "PPOConfig", "PPOMetrics", "TrainState",
    "compute_advantages", "make_learn_step", "make_optimizer",
    "make_train_state", "make_train_step", "normalize_advantages",
    "ppo_loss", "run_ppo_epochs", "RolloutCarry", "Transition",
    "init_carry", "rollout", "validate_rollout_geometry",
    "resolve_geometry", "run_minibatch_epochs", "validate_update_geometry",
]

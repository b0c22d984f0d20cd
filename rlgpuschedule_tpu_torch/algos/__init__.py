"""L4 RL algorithms of the port: rollout, the minibatch update engine,
PPO with its advantage options, V-trace and A2C."""
from . import a2c, action_dist, vtrace
from .a2c import A2CConfig, A2CMetrics
from .ppo import (ClippedAdam, ClippedRMSprop, PPOConfig, PPOMetrics,
                  RewardNormState, TrainState, compute_advantages,
                  init_reward_stats, make_learn_step, make_optimizer,
                  make_train_state, make_train_step, normalize_advantages,
                  ppo_loss, reward_scale, run_ppo_epochs,
                  update_reward_stats)
from .rollout import (RolloutCarry, Transition, init_carry, rollout,
                      validate_rollout_geometry)
from .update import (cast_floating, resolve_geometry, run_minibatch_epochs,
                     validate_update_geometry)
from .vtrace import compute_vtrace, importance_ratios

__all__ = [
    "a2c", "action_dist", "vtrace", "A2CConfig", "A2CMetrics",
    "ClippedAdam", "ClippedRMSprop", "PPOConfig", "PPOMetrics",
    "RewardNormState", "TrainState", "compute_advantages",
    "init_reward_stats", "make_learn_step", "make_optimizer",
    "make_train_state", "make_train_step", "normalize_advantages",
    "ppo_loss", "reward_scale", "run_ppo_epochs", "update_reward_stats",
    "RolloutCarry", "Transition", "init_carry", "rollout",
    "validate_rollout_geometry", "cast_floating", "resolve_geometry",
    "run_minibatch_epochs", "validate_update_geometry", "compute_vtrace",
    "importance_ratios",
]

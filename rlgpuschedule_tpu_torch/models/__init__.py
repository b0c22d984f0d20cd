"""L3 policy networks of the port."""
from .actor_critic import (NEG_INF, ActorCritic, GNNActorCritic, make_policy,
                           mask_logits)
from .convert import (load_npz, member_params, opt_state_from_jax,
                      params_from_jax)
from .encoders import CNNEncoder, GNNEncoder, MLPEncoder
from .hier import HierActorCritic, make_hier_policy

__all__ = ["ActorCritic", "GNNActorCritic", "MLPEncoder", "CNNEncoder",
           "GNNEncoder", "make_policy", "mask_logits", "NEG_INF",
           "params_from_jax", "load_npz", "opt_state_from_jax",
           "member_params", "HierActorCritic", "make_hier_policy"]

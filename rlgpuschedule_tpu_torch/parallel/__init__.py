"""L5 population training and PBT of the port (config 5), and the async
engine's actor/learner device groups. The mesh, data-parallel and
multihost modules of the JAX package's ``parallel/`` go with the
data-parallel slice (``ROADMAP.md`` queue 1, item 21)."""
from .groups import (DeviceGroups, parse_group_spec, split_devices,
                     split_mesh)
from .pbt import (PBTConfig, PBTController, PBTDecision, best_member_index,
                  exploit_explore, gather_members)
from .population import (HPARAM_BOUNDS, HParams, MemberState, init_member,
                         make_member_learn_step, make_member_optimizer,
                         make_member_step, member_hparams, sample_hparams,
                         stack_members)

__all__ = ["DeviceGroups", "parse_group_spec", "split_devices", "split_mesh",
           "PBTConfig", "PBTController", "PBTDecision", "best_member_index",
           "exploit_explore", "gather_members", "HPARAM_BOUNDS", "HParams",
           "MemberState", "init_member", "make_member_learn_step",
           "make_member_optimizer", "make_member_step", "member_hparams",
           "sample_hparams", "stack_members"]

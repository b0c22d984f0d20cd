"""PyTorch/CUDA port of ``rlgpuschedule_tpu``: greedy policy serving,
PPO training and the JCT evaluation.

It serves a scheduling policy greedily on an NVIDIA GPU through the
same two entry points as the JAX package's serving layer:

- :func:`.serve.fleet.fleet_replay` -- one policy against N seeded
  simulated clusters, the simulator, observation builder and policy all
  on the device at every decision step;
- :class:`.serve.engine.InferenceEngine` -- the same greedy decision on
  padded request batches, one power-of-two bucket at a time (one CUDA
  graph per bucket on the card), behind the continuous-batching
  :class:`.serve.batching.PolicyServer` and ``python -m
  rlgpuschedule_tpu_torch.serve --bench/--soak/--host-path``;

and trains it with PPO or A2C through :class:`.experiment.Experiment`,
or as a PBT population through :class:`.experiment
.PopulationExperiment`, and ``python -m rlgpuschedule_tpu_torch.train``:
rollout, GAE and the epoch x minibatch update on the device.

The modules mirror the JAX package's layout (``sim/core.py`` here is
the counterpart of ``sim/core.py`` there). Every function is batched
over a leading cluster axis ``E`` and takes an explicit device; the
default device is ``cuda`` (:mod:`.device`). The port imports neither
JAX nor the JAX package.

The simulator has the JAX package's pack and pack|spread placement and
its preemptive action space (the stall guard included), the
observations its flat, grid and topology-graph forms, and the
hierarchical multi-pod env of config 5 (:mod:`.env.hier`), for all five
configs and ``ppo-mlp-preempt``; the seeded cluster fault process
(:mod:`.sim.faults`) and domain randomization (:mod:`.domains`) ride
the flat configs' simulator, training, evaluation and fleet replay.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

"""Experiment assembly (L6) of the port: config -> traces, env, policy,
optimizer and the training loop.

Counterparts of ``build_env_params``, ``load_source_trace``,
``build_stack``, ``windows_per_pass``, ``drain_window``,
``make_env_windows`` (with the drain curriculum),
``make_domain_windows`` and the single-run
``Experiment`` of PPO or A2C (``build``, ``run`` with its eval,
checkpoint and window-streaming cadences and its ``fused_chunk``,
``run_fused``, ``run_async``, ``advance_windows``, ``save_checkpoint``,
``restore_checkpoint``, ``steps_per_iteration``, and the watchdog's
``scale_lr`` and ``fold_key``, which ``run(watchdog=, injector=)``
uses: :mod:`.resilience`) in the JAX package's
``experiment.py``, and its ``PopulationExperiment`` (config 5's PBT
population, :class:`PopulationExperiment`). A config with ``n_pods >
1`` builds the hierarchical env and policy (:mod:`.env.hier`,
:mod:`.models.hier`) and trains, streams windows and checkpoints as the
flat ones do. Meshes are not ported.

Faults and domains (``cfg.faults``, ``cfg.domains``, flat configs): the
experiment draws one schedule per env on the host, env ``e`` from
``(cfg.seed, e)`` as JAX draws it, and holds them batched on the device
(:attr:`Experiment.faults`) beside the traces; the rollout runs under
them. A domain run's windows are generated from the config's fitted job
mix under each env's draw (:func:`make_domain_windows`), and window
streaming regenerates them at the new cursor under the same draws. A
population member ``p`` draws its env ``e``'s schedule from
``(cfg.seed, p, e)``.

Random streams: the rollout samples from the carry's generator (seeded
``cfg.seed``) and the update permutes with another (seeded
``cfg.seed + 1``). A window resample resets every episode and keeps the
carry's generator, which goes on drawing where it was (JAX re-keys the
carry with a split); both generators' states are checkpointed.

Cadences count iterations over the experiment's whole life, across
``run`` calls and a restore (``Experiment.iteration``): a resample falls
just before iteration ``g`` whenever ``g % resample_every == 0`` and
``g > 0``. So a checkpoint written on a resample boundary holds the
state before the re-cut, and the run that restores it re-cuts first:
``k`` iterations, a save, a restore and ``k`` more are the ``2k``
uninterrupted ones for any cadence. Within one ``run`` from a fresh
build this is JAX's schedule; JAX counts each ``run`` call from 0 and
skips the resample after a call's last iteration.

``run_fused(k)`` is ``k`` train steps with no host sync and no hook in
between. JAX scans them as one program and derives its keys otherwise
than ``run``; the port's steps draw from the same generators either way,
so ``run_fused(k)`` is ``k`` iterations of ``run`` bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from .algos import a2c, ppo
from .algos.ppo import RewardNormState, TrainState
from .algos.rollout import (RolloutCarry, init_carry,
                            validate_rollout_geometry)
from .algos.update import validate_update_geometry
from .checkpoint import Checkpointer
from .configs import ExperimentConfig
from .device import resolve_device
from .domains import (domain_schedule, resolve_domain, sample_env_domains,
                      stack_domain_schedules, validate_domain_schedule)
from .env.env import EnvParams, stack_traces
from .env.hier import HierParams
from .env.obs import build_adjacency
from .models import (ActorCritic, GNNActorCritic, HierActorCritic,
                     make_hier_policy, make_policy)
from .sim.core import SimParams, Trace, validate_trace
from .sim.faults import (fault_horizon, resolve_regime,
                         sample_fault_schedule, stack_fault_schedules)
from .traces import (ArrayTrace, gen_pai_proxy_trace, gen_philly_proxy_trace,
                     gen_poisson_trace, load_pai, load_philly)
from .traces.fit import domain_fit, gen_domain_window


def build_hier_params(cfg: ExperimentConfig) -> HierParams:
    """The hierarchical env of a config with ``n_pods > 1``, with the
    JAX package's refusals word for word (faults and domains among
    them). Each pod is ``n_nodes // n_pods`` nodes; traces are validated
    against one pod."""
    if cfg.faults:
        raise ValueError(
            "hierarchical configs have no fault-process support yet "
            "(sim.faults is a flat-config feature); unset faults")
    if cfg.domains:
        raise ValueError(
            "hierarchical configs have no domain-randomization "
            "support yet (domain schedules carry per-node capacity "
            "through the flat sim path only); unset domains")
    if cfg.n_nodes % cfg.n_pods != 0:
        raise ValueError(f"n_nodes={cfg.n_nodes} not divisible by "
                         f"n_pods={cfg.n_pods}")
    if cfg.obs_kind != "flat" or cfg.reward_kind != "jct":
        raise ValueError(
            f"hierarchical configs use flat pod observations and the "
            f"JCT reward; got obs_kind={cfg.obs_kind!r}, "
            f"reward_kind={cfg.reward_kind!r}")
    if cfg.preempt_len:
        raise ValueError(
            "hierarchical configs do not support the preemptive action "
            "space (pod actions are queue-slot×placement + no-op); set "
            "preempt_len=0")
    pod_sim = SimParams(n_nodes=cfg.n_nodes // cfg.n_pods,
                        gpus_per_node=cfg.gpus_per_node,
                        max_jobs=cfg.window_jobs, queue_len=cfg.queue_len,
                        n_placements=cfg.n_placements)
    return HierParams(n_pods=cfg.n_pods, pod_sim=pod_sim,
                      time_scale=cfg.time_scale,
                      reward_scale=cfg.reward_scale,
                      place_bonus=cfg.place_bonus, horizon=cfg.horizon)


def trace_sim(env_params: "EnvParams | HierParams") -> SimParams:
    """The geometry traces are validated against: the cluster, or one
    pod of the hierarchical env (gangs do not span pods)."""
    if isinstance(env_params, HierParams):
        return env_params.pod_sim
    return env_params.sim


def build_env_params(cfg: ExperimentConfig) -> "EnvParams | HierParams":
    """The config's env: :class:`.env.env.EnvParams`, or
    :class:`.env.hier.HierParams` when ``n_pods > 1``
    (:func:`build_hier_params`). A flat config's observation gains the
    per-node health channel under ``faults`` or ``domains`` (a domain
    schedule carries slowdowns too) and the geometry channel under
    ``domains``; grid and graph observations pin their layouts, so they
    train under either without the channels."""
    if cfg.n_pods > 1:
        return build_hier_params(cfg)
    sim = SimParams(n_nodes=cfg.n_nodes, gpus_per_node=cfg.gpus_per_node,
                    max_jobs=cfg.window_jobs, queue_len=cfg.queue_len,
                    n_placements=cfg.n_placements,
                    preempt_len=cfg.preempt_len)
    fault_process = resolve_regime(cfg.faults) if cfg.faults else None
    domain_process = resolve_domain(cfg.domains) if cfg.domains else None
    flat = cfg.obs_kind == "flat"
    return EnvParams(sim=sim, obs_kind=cfg.obs_kind,
                     reward_kind=cfg.reward_kind, n_tenants=cfg.n_tenants,
                     time_scale=cfg.time_scale,
                     reward_scale=cfg.reward_scale,
                     place_bonus=cfg.place_bonus,
                     preempt_cost=cfg.preempt_cost, horizon=cfg.horizon,
                     fault_process=fault_process,
                     fault_obs=flat and (fault_process is not None
                                         or domain_process is not None),
                     domain_process=domain_process,
                     domain_obs=flat and domain_process is not None)


def load_source_trace(cfg: ExperimentConfig, n_jobs: int | None = None,
                      seed: int | None = None) -> ArrayTrace:
    """The full source trace this experiment schedules: generated from
    ``seed`` (default ``cfg.seed``) for the synthetic and proxy traces,
    ``n_jobs`` long (default ``cfg.source_jobs``, else one pass over the
    env batch); read from ``cfg.trace_path`` for the CSV traces, capped
    at ``n_jobs``."""
    seed = cfg.seed if seed is None else seed
    if cfg.trace in ("synthetic", "philly-proxy", "pai-proxy"):
        # source_jobs pins generated traces only; a CSV is its own size
        n_jobs = n_jobs or cfg.source_jobs
    if cfg.trace == "synthetic":
        n = n_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8), 1024)
        return gen_poisson_trace(cfg.arrival_rate, n, seed,
                                 mean_duration=cfg.mean_duration,
                                 n_tenants=max(cfg.n_tenants, 1))
    if cfg.trace in ("philly-proxy", "pai-proxy"):
        n = n_jobs or max(cfg.window_jobs * max(cfg.n_envs, 8), 4096)
        gen = (gen_philly_proxy_trace if cfg.trace == "philly-proxy"
               else gen_pai_proxy_trace)
        kw = {"n_tenants": cfg.n_tenants} if cfg.n_tenants else {}
        return gen(n, seed, n_gpus=cfg.total_gpus, load=cfg.trace_load,
                   max_gang=cfg.total_gpus, **kw)
    if cfg.trace_path is None:
        raise ValueError(
            f"config {cfg.name!r} uses trace={cfg.trace!r} but has no "
            f"trace_path; pass one (CSV) or use trace='synthetic'")
    loader = load_philly if cfg.trace == "philly" else load_pai
    return loader(cfg.trace_path, max_jobs=n_jobs)


def windows_per_pass(total_jobs: int, window_jobs: int) -> int:
    """Windows in one full tiling pass over the trace (the last window is
    the final ``window_jobs`` jobs, so every job is in some window)."""
    return max(-(-total_jobs // window_jobs), 1)


def drain_window(w: ArrayTrace) -> ArrayTrace:
    """A backlog-drain copy of a window: every job submitted at t=0, so
    the episode is only "drain this backlog", the regime where the
    ordering and packing decisions carry the whole JCT signal (see
    ``ExperimentConfig.drain_frac``)."""
    return dataclasses.replace(
        w, submit=np.where(w.valid, 0.0, np.inf).astype(np.float32))


def make_env_windows(cfg: ExperimentConfig, source: ArrayTrace,
                     start: int = 0) -> list[ArrayTrace]:
    """Cut ``n_envs`` episode windows out of the source trace: windows
    ``start + e`` of a tiling of the trace by ``window_jobs``, wrapping
    around at its end. Advancing ``start`` by ``n_envs`` per resample
    sweeps the whole trace every ``windows_per_pass / n_envs``
    resamples.

    With ``cfg.drain_frac > 0`` the last ``round(n_envs * drain_frac)``
    envs train on drained copies of their windows (the backlog-drain
    curriculum); resamples keep the same envs drained."""
    total = source.num_jobs
    if total < cfg.window_jobs:
        raise ValueError(f"source trace has {total} jobs < window "
                         f"{cfg.window_jobs}")
    per_pass = windows_per_pass(total, cfg.window_jobs)
    windows = []
    for e in range(cfg.n_envs):
        k = (start + e) % per_pass
        off = min(k * cfg.window_jobs, total - cfg.window_jobs)
        windows.append(source.slice(off, cfg.window_jobs))
    n_drain = int(round(cfg.n_envs * cfg.drain_frac))
    for e in range(cfg.n_envs - n_drain, cfg.n_envs):
        windows[e] = drain_window(windows[e])
    return windows


def make_domain_windows(cfg: ExperimentConfig, draws, start: int = 0,
                        ) -> list[ArrayTrace]:
    """The domain-randomized twin of :func:`make_env_windows`: one
    window per draw, generated from the config's fitted job mix
    (:func:`.traces.fit.domain_fit`) under the draw's arrival knobs and
    offered against its actual capacity. ``start`` is the streaming
    cursor: window ``e`` is seeded ``(cfg.seed, e, start)``, so a new
    cursor draws fresh windows of the same shape and a restore at a
    cursor regenerates the same ones. The drain tail works as in
    :func:`make_env_windows`, over the draws given."""
    fit = domain_fit(cfg)
    windows = []
    for e, d in enumerate(draws):
        total = d.total_gpus
        windows.append(gen_domain_window(
            fit, cfg.window_jobs, (cfg.seed, e, start), n_gpus=total,
            load=d.load, duration_scale=d.duration_scale,
            burst_frac=d.burst_frac, diurnal=d.diurnal, max_gang=total,
            n_tenants=max(cfg.n_tenants, 1)))
    n = len(windows)     # the matrix draws batches other than n_envs
    n_drain = int(round(n * cfg.drain_frac))
    for e in range(n - n_drain, n):
        windows[e] = drain_window(windows[e])
    return windows


def draw_schedules(cfg: ExperimentConfig, env_params, windows,
                   device: "torch.device | str | None" = None,
                   member: int | None = None):
    """The env batch's fault or domain schedules: ``(faults, domains)``,
    the batched device schedule (a ``DomainSchedule`` under
    ``cfg.domains``, composing any ``cfg.faults`` draw) and the host
    domain draws behind it; ``(None, None)`` for a healthy fixed
    cluster. Env ``e`` draws from ``(cfg.seed, e)``, or from
    ``(cfg.seed, member, e)`` for a population member, over the fault
    horizon of ``windows``."""
    fp = getattr(env_params, "fault_process", None)
    dp = getattr(env_params, "domain_process", None)
    if fp is None and dp is None:
        return None, None
    horizon_s = fault_horizon(windows)

    def seed(e):
        return (cfg.seed, e) if member is None else (cfg.seed, member, e)

    def fault(e):
        return (sample_fault_schedule(cfg.n_nodes, fp, seed(e), horizon_s)
                if fp is not None else None)

    if dp is None:
        return stack_fault_schedules(
            [fault(e) for e in range(cfg.n_envs)], device), None
    domains = sample_env_domains(dp, cfg.n_nodes, cfg.gpus_per_node,
                                 cfg.seed, cfg.n_envs)
    return stack_domain_schedules(
        [validate_domain_schedule(cfg.n_nodes, cfg.gpus_per_node,
                                  domain_schedule(d, fault(e)))
         for e, d in enumerate(domains)], device), domains


def build_policy(cfg: ExperimentConfig,
                 env_params: "EnvParams | HierParams", *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: "torch.device | str | None" = None,
                 seed: int | None = None,
                 ) -> "ActorCritic | GNNActorCritic | HierActorCritic":
    """The config's actor-critic, seeded ``seed`` (default ``cfg.seed``),
    on ``device``; a graph config's holds the adjacency of
    ``build_adjacency(n_nodes, queue_len, nodes_per_rack,
    preempt_len)``, a hierarchical config's is the
    :class:`.models.hier.HierActorCritic`."""
    seed = cfg.seed if seed is None else seed
    if isinstance(env_params, HierParams):
        return make_hier_policy(env_params, dtype=dtype, seed=seed,
                                device=device)
    kw = {}
    if cfg.obs_kind == "graph":
        kw = dict(adjacency=build_adjacency(cfg.n_nodes, cfg.queue_len,
                                            cfg.nodes_per_rack,
                                            cfg.preempt_len),
                  n_cluster_nodes=cfg.n_nodes, queue_len=cfg.queue_len,
                  n_placements=cfg.n_placements,
                  preempt_len=cfg.preempt_len)
    return make_policy(cfg.obs_kind, env_params.n_actions,
                       env_params.obs_shape(), dtype=dtype, seed=seed,
                       device=device, **kw)


def build_stack(cfg: ExperimentConfig,
                device: "torch.device | str | None" = None):
    """Trace load/validate/window/stack and the policy, on ``device``
    (default ``cuda``). Returns ``(env_params, windows, traces [E, ...],
    net, source)``; ``net(obs, mask)`` is the apply function (a graph
    policy holds its adjacency) and ``source`` the full validated source
    trace. Under ``cfg.domains`` the windows are generated per env under
    its domain draw (:func:`make_domain_windows`); the source is still
    loaded, for the full-trace table."""
    env_params = build_env_params(cfg)
    source = validate_trace(trace_sim(env_params), load_source_trace(cfg),
                            clamp=True)
    dp = getattr(env_params, "domain_process", None)
    if dp is not None:
        windows = make_domain_windows(cfg, sample_env_domains(
            dp, cfg.n_nodes, cfg.gpus_per_node, cfg.seed, cfg.n_envs))
    else:
        windows = make_env_windows(cfg, source)
    traces = stack_traces(windows, env_params, device)
    net = build_policy(cfg, env_params, device=device)
    return env_params, windows, traces, net, source


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy that owns its storage (a view would save its base)."""
    return t.detach().to("cpu", copy=True)


def _host_tree(tree):
    """:func:`_host` on every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree) if isinstance(tree, torch.Tensor) else tree


def _as_dicts(tree):
    """NamedTuples as dicts, recursively: what a checkpoint holds (an
    ``EnvState`` becomes ``{"sim": {...}, "t": ...}``, a ``HierState``
    ``{"pods": {...}, "assignment": ..., "t": ...}``)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: _as_dicts(v) for k, v in tree.items()}
    return tree


def _like(template, tree):
    """``tree`` (nested dicts) rebuilt into ``template``'s NamedTuples;
    keys the template does not have are ignored."""
    if hasattr(template, "_fields"):
        return type(template)(*(_like(getattr(template, f), tree[f])
                                for f in template._fields))
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    return tree


def carry_payload(carry: RolloutCarry) -> dict:
    """The checkpointed form of a rollout carry (its generator aside):
    the env state's fields, ``obs`` and ``mask``, as host tensors."""
    return _host_tree({**_as_dicts(carry.env_state), "obs": carry.obs,
                       "mask": carry.mask})


def carry_from_payload(template: RolloutCarry, c: dict,
                       generator: torch.Generator) -> RolloutCarry:
    """The inverse of :func:`carry_payload`, shaped like ``template``."""
    return RolloutCarry(_like(template.env_state, c),
                        _like(template.obs, c["obs"]),
                        _like(template.mask, c["mask"]), generator)


def restore_policy(ckpt: Checkpointer, net: torch.nn.Module,
                   step: int | None = None) -> dict:
    """Load the policy weights of checkpoint ``step`` (default: the
    newest that restores, :meth:`..checkpoint.Checkpointer.restore`)
    into ``net``, on its device; returns the checkpoint's meta. What a
    replay or a server needs of a checkpoint, whatever device wrote it.
    From a population's checkpoint it loads the fittest member by the
    saved controller's fitness window, and the meta gains ``member``."""
    from .parallel.pbt import PBTController, best_member_index
    dev = next(net.parameters()).device
    state, meta = ckpt.restore(step, map_location=dev)
    if "members" not in state:
        net.load_state_dict(state["policy"])
        return meta
    ctrl = PBTController(len(state["members"]))
    ctrl.load_state_dict(meta.get("pbt_controller"))
    if not ctrl.has_fitness:
        raise ValueError("the population checkpoint holds no fitness "
                         "record, so it has no fittest member to load")
    member = best_member_index(ctrl.mean_fitness)
    net.load_state_dict(state["members"][member]["policy"])
    return dict(meta, member=member)


def fold_generator(gen: torch.Generator, n: int) -> None:
    """Reseed ``gen`` from a hash of its state and ``n``: a stream other
    than the one it was on, the same one for the same state and ``n``
    (the counterpart of JAX's ``jax.random.fold_in(key, n)``)."""
    h = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8)
    h.update(int(n).to_bytes(8, "little", signed=True))
    gen.manual_seed(int.from_bytes(h.digest(), "little") >> 1)


def algo_config(cfg: ExperimentConfig):
    """The config's ``PPOConfig`` or ``A2CConfig``."""
    return cfg.ppo if cfg.algo == "ppo" else cfg.a2c


@dataclasses.dataclass
class Experiment:
    """An assembled PPO or A2C run: the train step and its host loop."""
    cfg: ExperimentConfig
    env_params: EnvParams
    windows: list            # host ArrayTrace windows
    traces: Trace            # batched device traces [E, ...]
    train_state: TrainState  # policy + optimizer, updated in place
    train_step: Callable
    carry: RolloutCarry      # env state, obs, mask, sampling generator
    generator: torch.Generator   # the update's permutation stream
    source: ArrayTrace
    device: torch.device
    window_cursor: int = 0   # first window index of the current env batch
    iteration: int = 0       # iterations trained over all run() calls
    # batched fault or domain schedules [E, ...] the rollout runs under
    # (None: a healthy fixed cluster), drawn at build from the config
    faults: object = None
    # the host domain draws behind a DomainSchedule in faults (window
    # streaming regenerates windows under them), or None
    domains: list | None = None

    @property
    def net(self) -> "ActorCritic | GNNActorCritic | HierActorCritic":
        return self.train_state.net

    @property
    def step(self) -> int:
        """The count of optimizer updates taken (iterations x epochs x
        minibatches): JAX's ``train_state.step``, and the number a
        checkpoint is saved under."""
        state = self.train_state.opt.state
        for p in self.net.parameters():
            if p in state:
                return int(state[p]["step"])
        return 0

    @staticmethod
    def build(cfg: ExperimentConfig,
              device: "torch.device | str | None" = None) -> "Experiment":
        """Policy from ``cfg.seed``, optimizer (PPO's clipped Adam or
        A2C's clipped RMSprop), first env reset. The rollout samples
        from a generator seeded ``cfg.seed`` and the update permutes
        with one seeded ``cfg.seed + 1``, both on ``device``."""
        dev = resolve_device(device)
        algo = algo_config(cfg)
        # fail fast on a geometry that cannot tile the rollout batch
        validate_rollout_geometry(algo.n_steps, cfg.n_envs)
        validate_update_geometry(algo.n_epochs, algo.n_minibatches,
                                 algo.minibatch_size, n_steps=algo.n_steps,
                                 n_envs=cfg.n_envs)
        env_params, windows, traces, net, source = build_stack(cfg, dev)
        faults, domains = draw_schedules(cfg, env_params, windows, dev)
        carry = init_carry(env_params, traces,
                           torch.Generator(dev).manual_seed(cfg.seed),
                           faults)
        lib = a2c if cfg.algo == "a2c" else ppo
        return Experiment(
            cfg=cfg, env_params=env_params, windows=windows, traces=traces,
            train_state=lib.make_train_state(net, algo),
            train_step=lib.make_train_step(env_params, algo), carry=carry,
            generator=torch.Generator(dev).manual_seed(cfg.seed + 1),
            source=source, device=dev, faults=faults, domains=domains)

    @property
    def steps_per_iteration(self) -> int:
        return algo_config(self.cfg).n_steps * self.cfg.n_envs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cut_windows(self, cursor: int) -> None:
        """Re-cut the env windows at tiling position ``cursor`` (the same
        shapes; the carry is left as it is). A domain run regenerates
        its windows at ``cursor`` under the same draws."""
        self.window_cursor = cursor
        self.windows = (
            make_domain_windows(self.cfg, self.domains, cursor)
            if self.domains is not None
            else make_env_windows(self.cfg, self.source, cursor))
        self.traces = stack_traces(self.windows, self.env_params,
                                   self.device)

    def advance_windows(self) -> None:
        """Rotate every env onto the next ``n_envs`` windows of the
        source tiling and reset every episode (window streaming: a long
        run covers the whole trace). The carry's generator goes on
        drawing where it was; the fault schedules stay (their times are
        episode-relative)."""
        self._cut_windows(self.window_cursor + self.cfg.n_envs)
        self.carry = init_carry(self.env_params, self.traces,
                                self.carry.generator, self.faults)

    def save_checkpoint(self, ckpt: Checkpointer, step: int | None = None,
                        meta: dict | None = None,
                        force: bool = False) -> bool:
        """Persist the policy, the optimizer (Adam's moments or
        RMSprop's, and the step), the reward moments when
        ``reward_norm`` is on, the rollout carry (env state, obs, mask)
        and the states of both generators under ``step`` (default
        :attr:`step`), all as host tensors; ``meta`` gains the config,
        ``iteration`` (the last one trained), ``window_cursor`` and the
        generators' device. ``force=True`` overwrites an existing step.
        JAX's checkpoint holds no reward moments (a JAX resume restarts
        them at zero); the port keeps them, so a resume continues the
        run bit for bit."""
        step = self.step if step is None else step
        c = self.carry
        state = {
            "policy": _host_tree(self.net.state_dict()),
            "optimizer": _host_tree(self.train_state.opt.state_dict()),
            "carry": carry_payload(c),
            "generators": {"sampling": c.generator.get_state().clone(),
                           "update": self.generator.get_state().clone()},
        }
        stats = self.train_state.reward_stats
        if stats is not None:
            state["reward_stats"] = _host_tree(stats._asdict())
        meta = dict(meta or {}, config=dataclasses.asdict(self.cfg),
                    iteration=self.iteration - 1,
                    window_cursor=self.window_cursor,
                    generator_device=self.device.type)
        return ckpt.save(step, state, meta=meta, force=force)

    def restore_checkpoint(self, ckpt: Checkpointer, step: int | None = None,
                           train: bool = True) -> dict:
        """Restore checkpoint ``step`` (default: the newest that
        restores) in place and return its meta. The windows are re-cut
        at its cursor. With ``train`` (the default) the optimizer, the
        carry, both generators and the iteration count come back too, so
        a resumed :meth:`run` reproduces the uninterrupted run bit for
        bit; the experiment must be built from the same config on the
        same kind of device (a generator's state does not carry between
        a CUDA and a CPU generator). ``train=False`` loads the policy
        and the cursor only: what a replay needs, from a checkpoint
        written on any device."""
        state, meta = ckpt.restore(step, map_location=self.device)
        wrote = meta.get("generator_device")
        if train and wrote != self.device.type:
            raise ValueError(
                f"checkpoint {ckpt.last_restored_step} holds {wrote} "
                f"generator states, which a {self.device.type} run cannot "
                f"continue; restore with train=False to replay its policy")
        self.net.load_state_dict(state["policy"])
        if train:
            self.train_state.opt.load_state_dict(state["optimizer"])
            # the config's learning rate, as JAX's restored opt_state
            # (which holds none) runs under the config's optimizer
            self.scale_lr(1.0)
            if self.train_state.reward_stats is not None:
                self.train_state = self.train_state._replace(
                    reward_stats=RewardNormState(**state["reward_stats"]))
            gen = self.carry.generator
            gen.set_state(state["generators"]["sampling"].cpu())
            self.generator.set_state(state["generators"]["update"].cpu())
            self.carry = carry_from_payload(self.carry, state["carry"], gen)
            self.iteration = int(meta["iteration"]) + 1
        cursor = int(meta.get("window_cursor", 0))
        if cursor != self.window_cursor:
            self._cut_windows(cursor)
        return meta

    def scale_lr(self, scale: float) -> None:
        """Set the learning rate of every optimizer param group (PPO's
        Adam, A2C's RMSprop) to ``scale`` x the config's: the watchdog's
        rollback decay. The optimizer's moments and step stay, as JAX's
        restored ``opt_state`` carries over under its rebuilt ``tx``."""
        lr = algo_config(self.cfg).lr * scale
        for group in self.train_state.opt.param_groups:
            group["lr"] = lr

    def fold_key(self, n: int) -> None:
        """Move both generators (the carry's sampling stream and the
        update's permutation stream) to new streams, each a function of
        its current state and ``n`` (the watchdog's retry: replaying the
        restored streams would resample the trajectory that diverged).
        The same restored state and ``n`` give the same streams."""
        fold_generator(self.carry.generator, n)
        fold_generator(self.generator, n)

    def validate_fused_chunk(self, fused_chunk: int, iterations: int, *,
                             log_every: int = 0, ckpt_every: int = 0,
                             eval_every: int = 0) -> None:
        """Raise ``ValueError`` unless ``fused_chunk`` divides every
        active cadence (0 = off), the iteration count and
        :attr:`iteration`, the run's start: :meth:`run`'s hooks then
        fall on chunk boundaries."""
        if fused_chunk <= 1:
            return
        cadences = {"log_every": log_every, "ckpt_every": ckpt_every,
                    "eval_every": eval_every,
                    "resample_every": self.cfg.resample_every,
                    "iterations": iterations}
        bad = {k: v for k, v in cadences.items() if v and v % fused_chunk}
        if bad:
            raise ValueError(
                f"fused_chunk={fused_chunk} must divide every active "
                f"cadence and the iteration count; offending: {bad}")
        if self.iteration % fused_chunk:
            raise ValueError(
                f"fused_chunk={fused_chunk} must divide the iteration the "
                f"run starts from ({self.iteration}), or the chunk "
                f"boundaries miss the cadences")

    def run_fused(self, iterations: int):
        """Run ``iterations`` train steps with no host sync and no hook
        (log, probe, checkpoint or window resample) between them;
        returns the last iteration's metrics, on the device. The steps
        are :meth:`run`'s on the same generators, so ``run_fused(k)`` is
        ``k`` iterations of ``run`` bit for bit."""
        if iterations < 1:
            raise ValueError(f"run_fused needs iterations >= 1, got "
                             f"{iterations}")
        metrics = None
        for _ in range(iterations):
            self.train_state, self.carry, metrics = self.train_step(
                self.train_state, self.carry, self.traces, self.generator,
                self.faults)
        self.iteration += iterations
        return metrics

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            ckpt: Checkpointer | None = None, ckpt_every: int = 0,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            fused_chunk: int = 1, watchdog=None, injector=None,
            telemetry=None) -> dict:
        """Run ``iterations`` (default ``cfg.iterations``) more training
        iterations; returns the summary (wall time, env steps per second,
        ``window_cursor``, logged history). Iteration ``g`` counts over
        the experiment's life (:attr:`iteration`, the module docstring's
        cadences): it is logged when ``g % log_every == 0`` and at the
        call's last iteration; a logged iteration costs one host sync
        (its metrics in one transfer).

        ``eval_fn(g) -> dict`` runs after iteration ``g`` when
        ``(g + 1) % eval_every == 0`` and at the last iteration (the
        in-training quality probe, e.g. a held-out JCT replay); its rows
        go to ``eval_logger`` and into the summary's ``eval_history``.
        With ``ckpt``, the experiment is saved after the probe at the
        same cadence of ``ckpt_every`` and at the last iteration; with
        ``cfg.resample_every`` the windows are re-cut before every
        ``resample_every``-th iteration. Nothing else in the loop waits
        for the device. ``wall_s`` and env-steps/s include the probes'
        and saves' time.

        ``fused_chunk > 1`` runs that many iterations at a time through
        :meth:`run_fused`, with the hooks at the chunk boundaries
        ``b = k * fused_chunk - 1`` (counted over the experiment's
        life), each cadence in the ``(b + 1) % L == 0`` form; every
        active cadence, the iteration count and the iteration the call
        starts from must be multiples of the chunk, so the hooks fire
        where the unchunked loop fires them (JAX's rule). Logged metrics
        are the boundary iteration's.

        ``watchdog`` (:class:`..resilience.DivergenceWatchdog`, needs
        ``ckpt``) checks every iteration's metrics, read in the same one
        transfer as a logged row, and on divergence rolls back to the
        last good checkpoint (saved first if the store is empty):
        :attr:`iteration` returns to the restored one and the call runs
        on until it reaches its start plus ``iterations``, the retried
        iterations logged again. With ``fused_chunk > 1`` only the
        boundaries' metrics are checked; resume points are checkpoint
        boundaries, which the chunk divides. ``injector``
        (:class:`..resilience.FaultInjector`) fires ``nan-grad`` after
        the matching iteration's step and ``corrupt-ckpt`` after its
        save. A :class:`..resilience.DivergenceError` reaches the caller
        once the rollback budget is spent. The summary then gains
        ``rollbacks`` and ``rollback_events``.

        ``telemetry`` (:class:`..obs.RunTelemetry`) traces the loop: a
        span per iteration (per chunk) with its phases (``step`` around
        the train step or :meth:`run_fused`, ``sync``, ``eval``,
        ``ckpt``, ``resample``), an ``iteration`` event at every logged
        iteration carrying the metrics this loop already read (telemetry
        adds no host read), and, with its alarms armed, the step under
        the recompile and transfer alarms; a rolled-back iteration is
        settled by ``iteration_aborted`` and its retry's step granted
        amnesty."""
        from .obs.trace import tracer_of
        from .utils.profiling import SectionTimer
        iterations = iterations or self.cfg.iterations
        if watchdog is not None and ckpt is None:
            raise ValueError(
                "watchdog rollback needs a checkpoint store; pass ckpt= "
                "(and a ckpt_every cadence so rollbacks stay short)")
        every = self.cfg.resample_every
        stride = max(fused_chunk, 1)
        self.validate_fused_chunk(
            stride, iterations, log_every=log_every,
            ckpt_every=ckpt_every if ckpt is not None else 0,
            eval_every=eval_every if eval_fn is not None else 0)
        history, eval_history = [], []
        # with no telemetry, a throwaway timer keeps the section sites
        # branch-free (two perf_counter reads per section)
        sections = (telemetry.sections if telemetry is not None
                    else SectionTimer())
        tracer = tracer_of(telemetry)
        if telemetry is not None:
            telemetry.run_start(
                loop="experiment", config=self.cfg.name,
                algo=self.cfg.algo, iterations=iterations,
                n_envs=self.cfg.n_envs,
                steps_per_iteration=self.steps_per_iteration,
                fused_chunk=fused_chunk)
        if watchdog is not None and ckpt.latest_step() is None:
            # a rollback target before the first periodic save: the
            # state before this call's first iteration
            self.save_checkpoint(ckpt)
        self._sync()
        t0 = time.perf_counter()
        end = self.iteration + iterations
        while self.iteration < end:
            g = self.iteration
            # the hooks see the chunk's last iteration (g when unchunked)
            b = g + stride - 1
            if telemetry is not None:
                telemetry.begin_iteration(b)
            if every and g and g % every == 0:
                with sections("resample"), tracer.span("resample"):
                    self.advance_windows()
            guard = (telemetry.dispatch(b) if telemetry is not None
                     else contextlib.nullcontext())
            with sections("step"), tracer.span("step"), guard:
                if stride > 1:
                    metrics = self.run_fused(stride)
                else:
                    self.train_state, self.carry, metrics = \
                        self.train_step(self.train_state, self.carry,
                                        self.traces, self.generator,
                                        self.faults)
                    self.iteration = g + 1
            if injector is not None:
                metrics = injector.poison_nan(self, b, metrics)
            last = self.iteration >= end
            # unchunked, log at phase 0 (b % L); chunked, at the
            # boundaries' phase ((b + 1) % L), as JAX does
            phase = b + 1 if stride > 1 else b
            want_log = bool(log_every) and (phase % log_every == 0 or last)
            m = None
            if watchdog is not None or want_log:
                # the watchdog and the logger share one host read
                with sections("sync"), tracer.span("sync"):
                    m = dict(zip(type(metrics)._fields,
                                 torch.stack(metrics).tolist()))
            if watchdog is not None:
                reason = watchdog.check(m)
                if reason is not None:
                    watchdog.rollback(self, ckpt, b, reason)
                    if telemetry is not None:
                        telemetry.iteration_aborted(b, f"rollback: {reason}")
                    continue
            if want_log:
                history.append({"iteration": b, **m})
                if logger is not None:
                    logger(b, m)
            if eval_fn is not None and eval_every and \
                    ((b + 1) % eval_every == 0 or last):
                with sections("eval"), tracer.span("eval"):
                    em = dict(eval_fn(b))
                eval_history.append({"iteration": b, **em})
                if eval_logger is not None:
                    eval_logger(b, em)
            if ckpt is not None and ckpt_every and \
                    ((b + 1) % ckpt_every == 0 or last):
                with sections("ckpt"), tracer.span("ckpt"):
                    self.save_checkpoint(ckpt)
                if injector is not None:
                    injector.corrupt_after_save(ckpt, b)
            if telemetry is not None:
                telemetry.end_iteration(b, m if want_log else None,
                                        stride * self.steps_per_iteration)
        self._sync()
        wall = time.perf_counter() - t0
        env_steps = iterations * self.steps_per_iteration
        out = {"wall_s": wall, "iterations": iterations,
               "env_steps": env_steps,
               "env_steps_per_sec": env_steps / wall,
               "window_cursor": self.window_cursor,
               "history": history}
        if watchdog is not None:
            out["rollbacks"] = watchdog.n_rollbacks
            out["rollback_events"] = [e.as_dict() for e in watchdog.events]
        if eval_history:
            out["eval_history"] = eval_history
        if telemetry is not None:
            telemetry.run_end(
                iterations=iterations, wall_s=round(wall, 6),
                env_steps=env_steps,
                env_steps_per_sec=round(out["env_steps_per_sec"], 3),
                rollbacks=(watchdog.n_rollbacks
                           if watchdog is not None else 0))
        return out

    def run_async(self, iterations: int | None = None, *,
                  groups=None, staleness_bound: int = 1,
                  queue_capacity: int = 2, log_every: int = 0,
                  logger: Callable[[int, dict], None] | None = None,
                  ckpt: Checkpointer | None = None, ckpt_every: int = 0,
                  eval_every: int = 0,
                  eval_fn: "Callable[[int], dict] | None" = None,
                  eval_logger: Callable[[int, dict], None] | None = None,
                  telemetry=None) -> dict:
        """The async actor-learner loop (:class:`..async_engine
        .AsyncRunner`): the rollout on the actor's stream (or device)
        overlaps the update on the learner's, through a bounded
        trajectory queue under ``staleness_bound``; ``staleness_bound=0``
        is :meth:`run` bit for bit. The hook surface and the cadences are
        :meth:`run`'s; checkpoints and window resamples run at
        drained-queue barriers. ``groups`` is a
        :class:`..parallel.groups.DeviceGroups` (default: both roles
        shared on this experiment's device). ``fused_chunk``, the
        watchdog and the fault injector are the sync loop's only, as in
        JAX."""
        from .async_engine import AsyncRunner
        runner = AsyncRunner(self, groups=groups,
                             staleness_bound=staleness_bound,
                             queue_capacity=queue_capacity)
        return runner.run(iterations, log_every=log_every, logger=logger,
                          ckpt=ckpt, ckpt_every=ckpt_every,
                          eval_every=eval_every, eval_fn=eval_fn,
                          eval_logger=eval_logger, telemetry=telemetry)


def member_seeds(seed: int, member: int) -> tuple[int, int, int]:
    """Population member ``member``'s seeds: its policy's
    initialization, its sampling generator and its update generator
    (three draws of ``np.random.SeedSequence([seed, member])``)."""
    return tuple(int(x) for x in
                 np.random.SeedSequence([seed, member]).generate_state(3))



@dataclasses.dataclass
class PopulationExperiment:
    """Config 5's assembly: a population of PPO members (each running the
    per-member config ``cfg``, for config 5 the hierarchical 4-pod agent)
    trained in turn on one device over the same env windows, with
    host-side PBT exploit/explore (:mod:`.parallel.pbt`).

    Member ``p`` owns its policy (seeded ``member_seeds(cfg.seed, p)[0]``),
    its clipped Adam, its rollout carry (sampling from a generator seeded
    ``member_seeds(...)[1]``) and its update generator
    (``member_seeds(...)[2]``); the ``Trace`` batch is one for all. The
    initial hyperparameters are :func:`.parallel.population
    .sample_hparams`'s, JAX's values. JAX splits one key into the
    members' streams instead, so the two packages' populations agree in
    distribution only (weights carried from JAX give the same replays).
    Cadences count iterations over the population's life
    (:attr:`iteration`), as :class:`Experiment`'s do; the windows are
    fixed (JAX's population has no window streaming)."""
    cfg: ExperimentConfig
    n_pop: int
    env_params: "EnvParams | HierParams"
    windows: list
    traces: Trace
    members: list            # MemberState per member
    carries: list            # RolloutCarry per member
    generators: list         # each member's update permutation stream
    hparams: object          # HParams, f32 [P] host arrays
    controller: object       # PBTController
    member_step: Callable
    source: ArrayTrace
    device: torch.device
    iteration: int = 0
    # each member's batched fault schedules [E, ...] (cfg.faults), drawn
    # from (seed, member, env) at build; None for a healthy cluster
    faults: list | None = None

    def __post_init__(self):
        self._refresh_hparams()

    def _refresh_hparams(self) -> None:
        from .parallel.population import member_hparams
        self.member_hp = [member_hparams(self.hparams, p, self.device)
                          for p in range(self.n_pop)]

    @staticmethod
    def build(cfg: ExperimentConfig, n_pop: int = 4, pbt_cfg=None,
              device: "torch.device | str | None" = None,
              mesh=None) -> "PopulationExperiment":
        """The population on ``device`` (default ``cuda``). Refuses an A2C
        config in JAX's words; a population mesh (``mesh``) waits for
        the data-parallel slice."""
        from .parallel.pbt import PBTConfig, PBTController
        from .parallel.population import (init_member, make_member_step,
                                          sample_hparams)
        if mesh is not None:
            raise NotImplementedError(
                "a population mesh (member stacks over a pop axis) is not "
                "in the PyTorch port yet: it waits for the data-parallel "
                "slice (ROADMAP.md queue 1, item 21)")
        if cfg.algo != "ppo":
            raise ValueError(
                f"PopulationExperiment trains PPO members (PBT explores "
                f"PPO hyperparameters); config {cfg.name!r} has "
                f"algo={cfg.algo!r}")
        if cfg.domains:
            raise ValueError(
                "PopulationExperiment does not thread domain schedules: "
                "per-member domain draws would need member-indexed trace "
                "windows through the population stack (cfg.domains=None; "
                "cfg.faults is supported)")
        if cfg.resample_every:
            raise ValueError(
                "PopulationExperiment trains every member on fixed "
                "windows (the population has no window streaming); unset "
                "resample_every")
        if n_pop < 1:
            raise ValueError(f"n_pop must be >= 1, got {n_pop}")
        dev = resolve_device(device)
        pbt_cfg = pbt_cfg or PBTConfig(seed=cfg.seed)
        validate_rollout_geometry(cfg.ppo.n_steps, cfg.n_envs)
        validate_update_geometry(cfg.ppo.n_epochs, cfg.ppo.n_minibatches,
                                 cfg.ppo.minibatch_size,
                                 n_steps=cfg.ppo.n_steps, n_envs=cfg.n_envs)
        env_params = build_env_params(cfg)
        source = validate_trace(trace_sim(env_params), load_source_trace(cfg),
                                clamp=True)
        windows = make_env_windows(cfg, source)
        traces = stack_traces(windows, env_params, dev)
        # every member trains on the same windows, each under its own
        # schedules: the population covers the regime P x E wide
        faults = ([draw_schedules(cfg, env_params, windows, dev, p)[0]
                   for p in range(n_pop)] if cfg.faults else None)
        members, carries, gens = [], [], []
        for p in range(n_pop):
            s_init, s_sample, s_update = member_seeds(cfg.seed, p)
            members.append(init_member(
                build_policy(cfg, env_params, device=dev, seed=s_init),
                cfg.ppo))
            carries.append(init_carry(
                env_params, traces, torch.Generator(dev).manual_seed(
                    s_sample), faults[p] if faults else None))
            gens.append(torch.Generator(dev).manual_seed(s_update))
        return PopulationExperiment(
            cfg=cfg, n_pop=n_pop, env_params=env_params, windows=windows,
            traces=traces, members=members, carries=carries,
            generators=gens,
            hparams=sample_hparams(cfg.ppo, n_pop, cfg.seed),
            controller=PBTController(n_pop, pbt_cfg),
            member_step=make_member_step(env_params, cfg.ppo),
            source=source, device=dev, faults=faults)

    @property
    def steps_per_iteration(self) -> int:
        return self.cfg.ppo.n_steps * self.cfg.n_envs * self.n_pop

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def step(self) -> int:
        """The most Adam updates any member has taken (JAX's
        ``max(states.step)``): the number a checkpoint is saved under."""
        steps = [0]
        for m in self.members:
            for p in m.net.parameters():
                if p in m.opt.state:
                    steps.append(int(m.opt.state[p]["step"]))
                break
        return max(steps)

    def best_member(self) -> int:
        """Index of the fittest member by windowed mean fitness (NaN ranks
        worst, the exploit's ordering). Raises when no fitness has been
        recorded: an argmax over zeros would crown member 0."""
        from .parallel.pbt import best_member_index
        if not self.controller.has_fitness:
            raise ValueError(
                "population has no recorded fitness (pre-controller-state "
                "checkpoint, or no training iterations ran); pass an "
                "explicit member index instead")
        return best_member_index(self.controller.mean_fitness)

    def member_eval_view(self, m: int | None = None):
        """An :class:`Experiment`-like view of member ``m`` (default: the
        fittest) for the eval harness (``eval.jct_report(pop
        .member_eval_view())``): the member's policy beside the
        population's config, env, windows, traces and source."""
        import types
        m = self.best_member() if m is None else m
        if not 0 <= m < self.n_pop:
            raise ValueError(f"member {m} out of range [0, {self.n_pop})")
        return types.SimpleNamespace(
            cfg=self.cfg, env_params=self.env_params, windows=self.windows,
            traces=self.traces, source=self.source, device=self.device,
            net=self.members[m].net, member=m, window_cursor=0)

    def save_checkpoint(self, ckpt: Checkpointer, step: int | None = None,
                        meta: dict | None = None,
                        force: bool = False) -> bool:
        """Persist the whole population in one checkpoint: every member's
        policy, optimizer (Adam's moments and step), rollout carry and
        both generators' states, and the hyperparameters; ``meta`` gains
        the config, ``iteration``, ``n_pop``, ``pbt_events`` and the
        full controller state (``pbt_controller``: RNG, fitness window,
        decision history), so a resumed run decides as the uninterrupted
        one does, bit for bit."""
        step = self.step if step is None else step
        state = {
            "members": [
                {"policy": _host_tree(m.net.state_dict()),
                 "optimizer": _host_tree(m.opt.state_dict()),
                 "carry": carry_payload(c),
                 "generators": {"sampling": c.generator.get_state().clone(),
                                "update": g.get_state().clone()}}
                for m, c, g in zip(self.members, self.carries,
                                   self.generators)],
            "hparams": {k: torch.from_numpy(np.array(v, np.float32))
                        for k, v in self.hparams._asdict().items()},
        }
        meta = dict(meta or {}, config=dataclasses.asdict(self.cfg),
                    iteration=self.iteration - 1, n_pop=self.n_pop,
                    generator_device=self.device.type,
                    pbt_events=len(self.controller.history),
                    pbt_controller=self.controller.state_dict())
        return ckpt.save(step, state, meta=meta, force=force)

    def restore_checkpoint(self, ckpt: Checkpointer, step: int | None = None,
                           train: bool = True) -> dict:
        """Restore checkpoint ``step`` (default: the newest that restores)
        in place and return its meta. The policies, the hyperparameters
        and the controller always come back; with ``train`` (the
        default) also the optimizers, the carries, the generators and the
        iteration count, so a resumed :meth:`run` is the uninterrupted
        run bit for bit (same config, same kind of device).
        ``train=False`` is what a replay needs, from any device."""
        from .parallel.population import HParams
        state, meta = ckpt.restore(step, map_location=self.device)
        if len(state["members"]) != self.n_pop:
            raise ValueError(
                f"checkpoint {ckpt.last_restored_step} holds "
                f"{len(state['members'])} members; this population has "
                f"{self.n_pop} (pass --n-pop {len(state['members'])})")
        wrote = meta.get("generator_device")
        if train and wrote != self.device.type:
            raise ValueError(
                f"checkpoint {ckpt.last_restored_step} holds {wrote} "
                f"generator states, which a {self.device.type} run cannot "
                f"continue; restore with train=False to replay its "
                f"policies")
        for p, saved in enumerate(state["members"]):
            self.members[p].net.load_state_dict(saved["policy"])
            if train:
                self.members[p].opt.load_state_dict(saved["optimizer"])
                gen = self.carries[p].generator
                gen.set_state(saved["generators"]["sampling"].cpu())
                self.generators[p].set_state(
                    saved["generators"]["update"].cpu())
                self.carries[p] = carry_from_payload(
                    self.carries[p], saved["carry"], gen)
        self.hparams = HParams(**{k: v.cpu().numpy()
                                  for k, v in state["hparams"].items()})
        self._refresh_hparams()
        self.controller.load_state_dict(meta.get("pbt_controller"))
        if train:
            self.iteration = int(meta["iteration"]) + 1
        return meta

    def scale_lr(self, scale: float) -> None:
        """The watchdog's rollback decay for the population: each
        member's learning rate lives in the host f32 hyperparameters (set
        on its optimizer before each step), so the decay multiplies
        them."""
        self.hparams = self.hparams._replace(
            lr=np.asarray(self.hparams.lr * scale, np.float32))
        self._refresh_hparams()

    def fold_key(self, n: int) -> None:
        """Move every member's two generators to new streams
        (:meth:`Experiment.fold_key`'s contract)."""
        for carry, gen in zip(self.carries, self.generators):
            fold_generator(carry.generator, n)
            fold_generator(gen, n)

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            ckpt: Checkpointer | None = None, ckpt_every: int = 0,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            watchdog=None, injector=None, telemetry=None) -> dict:
        """Train the population ``iterations`` (default ``cfg.iterations``)
        more iterations; PBT exploit/explore fires every
        ``controller.cfg.ready_iters`` recorded iterations. Each
        iteration steps the members in turn, records their fitness (the
        mean reward, left on the device) and asks the controller.

        Iteration ``g`` (over the population's life) is logged when ``g %
        log_every == 0`` and at the call's last iteration, with one
        column per member (``{metric}_{p}``) and the mean
        (``{metric}_mean``), in one transfer. ``eval_fn(g)`` runs when
        ``(g + 1) % eval_every == 0`` and at the last iteration, after
        the fitness record (so it may rank members with
        :meth:`best_member`); then the checkpoint, at ``ckpt_every``'s
        cadence and at the last iteration. Returns the summary: wall
        time, env steps per second, each member's final fitness, the
        count of PBT rounds (``pbt_events``) and the logged history.

        ``watchdog`` (needs ``ckpt``) handles only the catastrophic case,
        every member's fitness non-finite (read in one transfer an
        iteration), by rolling the whole population back to the last
        good checkpoint, as :meth:`Experiment.run` does; a single
        diverged member is PBT's job (the exploit treats non-finite
        fitness as dead and re-seeds it from the best member).
        ``injector`` fires ``nan-grad`` (spec ``rank`` = the member
        poisoned) after the step and ``corrupt-ckpt`` after the save.

        ``telemetry`` (:class:`..obs.RunTelemetry`) traces the loop as
        :meth:`Experiment.run` does, the members' steps being the
        ``step`` phase (under the alarms, when armed), and emits a
        ``pbt_exploit`` event per exploit round; each ``iteration`` event
        carries the logged row's per-member and ``{metric}_mean``
        columns."""
        from .algos.ppo import PPOMetrics
        from .obs.trace import tracer_of
        from .parallel.population import stack_members
        from .utils.profiling import SectionTimer
        iterations = iterations or self.cfg.iterations
        if watchdog is not None and ckpt is None:
            raise ValueError(
                "watchdog rollback needs a checkpoint store; pass ckpt= "
                "(and a ckpt_every cadence so rollbacks stay short)")
        history, eval_history = [], []
        sections = (telemetry.sections if telemetry is not None
                    else SectionTimer())
        tracer = tracer_of(telemetry)
        if telemetry is not None:
            telemetry.run_start(
                loop="population", config=self.cfg.name,
                n_pop=self.n_pop, iterations=iterations,
                n_envs=self.cfg.n_envs,
                steps_per_iteration=self.steps_per_iteration)
        if watchdog is not None and ckpt.latest_step() is None:
            self.save_checkpoint(ckpt)
        self._sync()
        t0 = time.perf_counter()
        end = self.iteration + iterations
        while self.iteration < end:
            g = self.iteration
            if telemetry is not None:
                telemetry.begin_iteration(g)
            guard = (telemetry.dispatch(g) if telemetry is not None
                     else contextlib.nullcontext())
            with sections("step"), tracer.span("step"), guard:
                per_member = []
                for p in range(self.n_pop):
                    self.members[p], self.carries[p], m = self.member_step(
                        self.members[p], self.carries[p], self.traces,
                        self.generators[p], self.member_hp[p],
                        self.faults[p] if self.faults else None)
                    per_member.append(m)
                metrics = stack_members(per_member)
            if injector is not None:
                metrics = injector.poison_nan_member(self, g, metrics)
            if watchdog is not None:
                reason = watchdog.check_population(metrics.mean_reward)
                if reason is not None:
                    watchdog.rollback(self, ckpt, g, reason)
                    if telemetry is not None:
                        telemetry.iteration_aborted(g, f"rollback: {reason}")
                    continue
            self.controller.record(metrics.mean_reward)
            out = self.controller.maybe_update(g, self.members, self.hparams)
            if out is not None:
                self.members, self.hparams, decision = out
                self._refresh_hparams()
                if telemetry is not None:
                    telemetry.emit(
                        "pbt_exploit", iteration=g,
                        exploited=int(decision.exploited.sum()),
                        src=[int(s) for s in decision.src])
            self.iteration = g + 1
            last = self.iteration >= end
            row = None
            if log_every and (g % log_every == 0 or last):
                with sections("sync"), tracer.span("sync"):
                    vals = torch.stack(list(metrics)).tolist()  # one read
                row = {}
                for name, v in zip(PPOMetrics._fields, vals):
                    row.update({f"{name}_{p}": x for p, x in enumerate(v)})
                    row[f"{name}_mean"] = sum(v) / len(v)
                history.append({"iteration": g, **row})
                if logger is not None:
                    logger(g, row)
            if eval_fn is not None and eval_every and \
                    ((g + 1) % eval_every == 0 or last):
                with sections("eval"), tracer.span("eval"):
                    em = dict(eval_fn(g))
                eval_history.append({"iteration": g, **em})
                if eval_logger is not None:
                    eval_logger(g, em)
            if ckpt is not None and ckpt_every and \
                    ((g + 1) % ckpt_every == 0 or last):
                with sections("ckpt"), tracer.span("ckpt"):
                    self.save_checkpoint(ckpt)
                if injector is not None:
                    injector.corrupt_after_save(ckpt, g)
            if telemetry is not None:
                telemetry.end_iteration(g, row, self.steps_per_iteration)
        self._sync()
        wall = time.perf_counter() - t0
        env_steps = iterations * self.steps_per_iteration
        out = {"wall_s": wall, "iterations": iterations,
               "env_steps": env_steps,
               "env_steps_per_sec": env_steps / wall,
               "final_fitness": [float(f) for f in
                                 self.controller.mean_fitness],
               "pbt_events": len(self.controller.history),
               "history": history}
        if watchdog is not None:
            out["rollbacks"] = watchdog.n_rollbacks
            out["rollback_events"] = [e.as_dict() for e in watchdog.events]
        if eval_history:
            out["eval_history"] = eval_history
        if telemetry is not None:
            telemetry.run_end(
                iterations=iterations, wall_s=round(wall, 6),
                env_steps=env_steps,
                env_steps_per_sec=round(out["env_steps_per_sec"], 3),
                pbt_events=len(self.controller.history),
                rollbacks=(watchdog.n_rollbacks
                           if watchdog is not None else 0))
        return out

    def run_async(self, iterations: int | None = None, *,
                  groups=None, staleness_bound: int = 1,
                  queue_capacity: int = 2, log_every: int = 0,
                  logger: Callable[[int, dict], None] | None = None,
                  ckpt: Checkpointer | None = None, ckpt_every: int = 0,
                  eval_every: int = 0,
                  eval_fn: "Callable[[int], dict] | None" = None,
                  eval_logger: Callable[[int, dict], None] | None = None,
                  telemetry=None) -> dict:
        """The async actor-learner loop over the whole population
        (:class:`..async_engine.AsyncPopulationRunner`): the actor rolls
        each member in turn, the learner updates each in turn, PBT
        exploit/explore fires at drained-queue barriers, and
        ``staleness_bound=0`` is :meth:`run` bit for bit. Deep bounds
        want ``cfg.ppo.correction="vtrace"`` so stale batches do not skew
        the members' fitness ranking. The watchdog and the fault
        injector are the sync loop's only, as in JAX."""
        from .async_engine import AsyncPopulationRunner
        runner = AsyncPopulationRunner(self, groups=groups,
                                       staleness_bound=staleness_bound,
                                       queue_capacity=queue_capacity)
        return runner.run(iterations, log_every=log_every, logger=logger,
                          ckpt=ckpt, ckpt_every=ckpt_every,
                          eval_every=eval_every, eval_fn=eval_fn,
                          eval_logger=eval_logger, telemetry=telemetry)

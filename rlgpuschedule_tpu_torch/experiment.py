"""Experiment assembly (L6) of the port: config -> traces, env, policy,
optimizer and the training loop.

Counterparts of ``build_env_params``, ``load_source_trace``,
``build_stack``, ``windows_per_pass``, ``drain_window``,
``make_env_windows`` (with the drain curriculum) and the single-run
``Experiment`` of PPO or A2C (``build``, ``run`` with its eval,
checkpoint and window-streaming cadences and its ``fused_chunk``,
``run_fused``, ``advance_windows``, ``save_checkpoint``,
``restore_checkpoint``, ``steps_per_iteration``) in the JAX package's
``experiment.py``. Meshes, faults and domains are not ported; the
hierarchical config is refused here with ``NotImplementedError``.

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

import dataclasses
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
from .env.env import EnvParams, EnvState, stack_traces
from .env.obs import build_adjacency
from .models import ActorCritic, GNNActorCritic, make_policy
from .sim.core import SimParams, SimState, Trace, validate_trace
from .traces import (ArrayTrace, gen_pai_proxy_trace, gen_philly_proxy_trace,
                     gen_poisson_trace, load_pai, load_philly)


def build_env_params(cfg: ExperimentConfig) -> EnvParams:
    if cfg.n_pods > 1:
        raise NotImplementedError(
            f"config {cfg.name!r} has n_pods={cfg.n_pods}: the "
            f"hierarchical env (hier-pbt-member) waits for the config-5 "
            f"slice")
    sim = SimParams(n_nodes=cfg.n_nodes, gpus_per_node=cfg.gpus_per_node,
                    max_jobs=cfg.window_jobs, queue_len=cfg.queue_len,
                    n_placements=cfg.n_placements,
                    preempt_len=cfg.preempt_len)
    return EnvParams(sim=sim, obs_kind=cfg.obs_kind,
                     reward_kind=cfg.reward_kind, n_tenants=cfg.n_tenants,
                     time_scale=cfg.time_scale,
                     reward_scale=cfg.reward_scale,
                     place_bonus=cfg.place_bonus,
                     preempt_cost=cfg.preempt_cost, horizon=cfg.horizon)


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


def build_policy(cfg: ExperimentConfig, env_params: EnvParams, *,
                 dtype: torch.dtype = torch.bfloat16,
                 device: "torch.device | str | None" = None,
                 ) -> "ActorCritic | GNNActorCritic":
    """The config's actor-critic, seeded ``cfg.seed``, on ``device``; a
    graph config's holds the adjacency of ``build_adjacency(n_nodes,
    queue_len, nodes_per_rack, preempt_len)``."""
    kw = {}
    if cfg.obs_kind == "graph":
        kw = dict(adjacency=build_adjacency(cfg.n_nodes, cfg.queue_len,
                                            cfg.nodes_per_rack,
                                            cfg.preempt_len),
                  n_cluster_nodes=cfg.n_nodes, queue_len=cfg.queue_len,
                  n_placements=cfg.n_placements,
                  preempt_len=cfg.preempt_len)
    return make_policy(cfg.obs_kind, env_params.n_actions,
                       env_params.obs_shape(), dtype=dtype, seed=cfg.seed,
                       device=device, **kw)


def build_stack(cfg: ExperimentConfig,
                device: "torch.device | str | None" = None):
    """Trace load/validate/window/stack and the policy, on ``device``
    (default ``cuda``). Returns ``(env_params, windows, traces [E, ...],
    net, source)``; ``net(obs, mask)`` is the apply function (a graph
    policy holds its adjacency) and ``source`` the full validated source
    trace."""
    env_params = build_env_params(cfg)
    source = validate_trace(env_params.sim, load_source_trace(cfg),
                            clamp=True)
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


def restore_policy(ckpt: Checkpointer, net: torch.nn.Module,
                   step: int | None = None) -> dict:
    """Load the policy weights of checkpoint ``step`` (default: the
    newest that restores, :meth:`..checkpoint.Checkpointer.restore`)
    into ``net``, on its device; returns the checkpoint's meta. What a
    replay or a server needs of a checkpoint, whatever device wrote
    it."""
    dev = next(net.parameters()).device
    state, meta = ckpt.restore(step, map_location=dev)
    net.load_state_dict(state["policy"])
    return meta


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

    @property
    def net(self) -> "ActorCritic | GNNActorCritic":
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
        carry = init_carry(env_params, traces,
                           torch.Generator(dev).manual_seed(cfg.seed))
        lib = a2c if cfg.algo == "a2c" else ppo
        return Experiment(
            cfg=cfg, env_params=env_params, windows=windows, traces=traces,
            train_state=lib.make_train_state(net, algo),
            train_step=lib.make_train_step(env_params, algo), carry=carry,
            generator=torch.Generator(dev).manual_seed(cfg.seed + 1),
            source=source, device=dev)

    @property
    def steps_per_iteration(self) -> int:
        return algo_config(self.cfg).n_steps * self.cfg.n_envs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cut_windows(self, cursor: int) -> None:
        """Re-cut the env windows at tiling position ``cursor`` (the same
        shapes; the carry is left as it is)."""
        self.window_cursor = cursor
        self.windows = make_env_windows(self.cfg, self.source, cursor)
        self.traces = stack_traces(self.windows, self.env_params,
                                   self.device)

    def advance_windows(self) -> None:
        """Rotate every env onto the next ``n_envs`` windows of the
        source tiling and reset every episode (window streaming: a long
        run covers the whole trace). The carry's generator goes on
        drawing where it was."""
        self._cut_windows(self.window_cursor + self.cfg.n_envs)
        self.carry = init_carry(self.env_params, self.traces,
                                self.carry.generator)

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
            "carry": {"sim": _host_tree(c.env_state.sim._asdict()),
                      "t": _host(c.env_state.t), "obs": _host(c.obs),
                      "mask": _host(c.mask)},
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
            if self.train_state.reward_stats is not None:
                self.train_state = self.train_state._replace(
                    reward_stats=RewardNormState(**state["reward_stats"]))
            c = state["carry"]
            gen = self.carry.generator
            gen.set_state(state["generators"]["sampling"].cpu())
            self.generator.set_state(state["generators"]["update"].cpu())
            self.carry = RolloutCarry(
                EnvState(sim=SimState(**c["sim"]), t=c["t"]), c["obs"],
                c["mask"], gen)
            self.iteration = int(meta["iteration"]) + 1
        cursor = int(meta.get("window_cursor", 0))
        if cursor != self.window_cursor:
            self._cut_windows(cursor)
        return meta

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
                self.train_state, self.carry, self.traces, self.generator)
        self.iteration += iterations
        return metrics

    def run(self, iterations: int | None = None, log_every: int = 0,
            logger: Callable[[int, dict], None] | None = None,
            ckpt: Checkpointer | None = None, ckpt_every: int = 0,
            eval_every: int = 0,
            eval_fn: "Callable[[int], dict] | None" = None,
            eval_logger: Callable[[int, dict], None] | None = None,
            fused_chunk: int = 1) -> dict:
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
        are the boundary iteration's."""
        iterations = iterations or self.cfg.iterations
        every = self.cfg.resample_every
        stride = max(fused_chunk, 1)
        self.validate_fused_chunk(
            stride, iterations, log_every=log_every,
            ckpt_every=ckpt_every if ckpt is not None else 0,
            eval_every=eval_every if eval_fn is not None else 0)
        history, eval_history = [], []
        self._sync()
        t0 = time.perf_counter()
        done = 0
        while done < iterations:
            g = self.iteration
            if every and g and g % every == 0:
                self.advance_windows()
            if stride > 1:
                metrics = self.run_fused(stride)
            else:
                self.train_state, self.carry, metrics = self.train_step(
                    self.train_state, self.carry, self.traces,
                    self.generator)
                self.iteration = g + 1
            done += stride
            b = self.iteration - 1
            last = done >= iterations
            # unchunked, log at phase 0 (b % L); chunked, at the
            # boundaries' phase ((b + 1) % L), as JAX does
            phase = b + 1 if stride > 1 else b
            if log_every and (phase % log_every == 0 or last):
                m = dict(zip(type(metrics)._fields,
                             torch.stack(metrics).tolist()))
                history.append({"iteration": b, **m})
                if logger is not None:
                    logger(b, m)
            if eval_fn is not None and eval_every and \
                    ((b + 1) % eval_every == 0 or last):
                em = dict(eval_fn(b))
                eval_history.append({"iteration": b, **em})
                if eval_logger is not None:
                    eval_logger(b, em)
            if ckpt is not None and ckpt_every and \
                    ((b + 1) % ckpt_every == 0 or last):
                self.save_checkpoint(ckpt)
        self._sync()
        wall = time.perf_counter() - t0
        env_steps = iterations * self.steps_per_iteration
        out = {"wall_s": wall, "iterations": iterations,
               "env_steps": env_steps,
               "env_steps_per_sec": env_steps / wall,
               "window_cursor": self.window_cursor,
               "history": history}
        if eval_history:
            out["eval_history"] = eval_history
        return out

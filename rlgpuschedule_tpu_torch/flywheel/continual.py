"""Continual training from served traffic: the flywheel's learn path.

Counterpart of the JAX package's ``flywheel/continual.py``:
``train --continual LOGDIR`` lands here. Verified flight-log shards
(:mod:`.flightlog`) become off-policy pseudo-trajectories and feed the
port's PPO learn step (:func:`..algos.ppo.make_learn_step`) with
``correction="vtrace"``: logged traffic lags the learner, and V-trace
corrects that lag. The lag is measured per shard:

- **staleness**: ``learner_step - shard.policy_step``
  (``flywheel_shard_staleness``);
- **importance ratios**: one batched forward under the learner's
  weights gives target log-probs against the shard's stored behavior
  log-probs (``flywheel_rho_mean`` / ``flywheel_rho_max``);
- **trust region**: a shard whose mean ratio leaves ``[1/trust,
  trust]`` or whose max ratio exceeds ``rho_max_cap`` is refused
  (``flywheel_shards_refused_total``).

Rows fold into ``[T, E]`` pseudo-trajectories (row ``t*E + e`` is step
``t``, lane ``e``), ``done`` stays False, the reward is the row's
deadline outcome (+1, or -1 when served late) and the scan bootstraps
from the last row batch's stored value, as in JAX.

A freshly logged shard is on-policy only up to the card's rounding: its
stored log-prob comes from the capture graph at the dispatch's bucket,
the target from one batched forward (in bf16 for config 2's trunk), so
its ratios sit in a band around 1, not at 1 (``chip_smoke.py`` phase 23
holds them to phase 17's bands).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from ..algos import action_dist
from ..algos.ppo import make_learn_step
from ..algos.rollout import Transition
from ..decision import (gate_stalled, greedy_actions, preempt_slice,
                        stall_threshold)
from ..tree import leaves, tree_map
from .flightlog import (FlightLogData, FlightLogError, FlightShard,
                        read_flight_log, unflatten_like)


@dataclasses.dataclass
class IngestReport:
    """What one ingest pass accepted and refused, shard by shard."""
    shards_seen: int
    shards_accepted: int
    shards_refused: int
    rows_accepted: int
    torn_tail: bool
    per_shard: "list[dict]"


def gate_logged_mask(mask: Any, stall, env_params):
    """Re-apply the serving engines' stall gate to a logged pre-gate mask
    column (host arrays): the stored log-prob and value came out of the
    engine's program after :func:`..decision.gate_stalled`, so a target
    distribution compared with them must see the same gated mask. A
    no-op without ``env_params`` or without preempt actions."""
    pre = preempt_slice(env_params) if env_params is not None else None
    if pre is None:
        return mask
    cpu = torch.device("cpu")
    return gate_stalled(_put(mask, cpu),
                        _put(np.asarray(stall, np.int32), cpu),
                        stall_threshold(env_params), pre).numpy()


def _put(tree: Any, dev: torch.device) -> Any:
    """Host arrays as tensors on ``dev`` (a read-only array is copied)."""
    return tree_map(lambda x: torch.from_numpy(
        np.require(x, requirements="W")).to(dev), tree)


def shard_rho_stats(policy: nn.Module, shard: FlightShard,
                    example_obs: Any, example_mask: Any,
                    example_act: Any, env_params=None,
                    ) -> "tuple[float, float]":
    """(mean, max) unclipped importance ratios of ``shard`` under the
    policy's current weights: one batched forward, the target log-prob
    against the shard's stored behavior log-prob (in f64 on the host).
    ``env_params`` re-applies the serving stall gate to the logged
    mask."""
    dev = next(policy.parameters()).device
    obs = unflatten_like(example_obs, shard.obs_leaves)
    mask = gate_logged_mask(
        unflatten_like(example_mask, shard.mask_leaves), shard.stall,
        env_params)
    act = unflatten_like(example_act, shard.act_leaves)
    with torch.no_grad():
        logits, _ = policy(_put(obs, dev), _put(mask, dev))
        target_lp = action_dist.log_prob(logits, _put(act, dev))
    rho = np.exp(target_lp.cpu().numpy().astype(np.float64)
                 - np.asarray(shard.log_prob, np.float64))
    return float(rho.mean()), float(rho.max())


def admit_shards(data: FlightLogData, policy: nn.Module, learner_step: int,
                 example_obs: Any, example_mask: Any, example_act: Any,
                 trust: float = 2.0, rho_max_cap: float = 8.0,
                 registry=None, env_params=None,
                 ) -> "tuple[list[FlightShard], IngestReport]":
    """Trust-region admission over every verified shard: the accepted
    shards (seq order) and the per-shard report. With a registry, the
    staleness and ratio gauges and the two counters."""
    if trust < 1.0:
        raise ValueError(f"trust must be >= 1.0, got {trust}")
    g_stale = g_mean = g_max = c_refused = c_ingested = None
    if registry is not None:
        g_stale = registry.gauge(
            "flywheel_shard_staleness",
            "learner_step - policy_step of the last shard considered "
            "for ingest (behavior lag, in train steps)")
        g_mean = registry.gauge(
            "flywheel_rho_mean",
            "mean unclipped V-trace importance ratio of the last shard "
            "considered for ingest")
        g_max = registry.gauge(
            "flywheel_rho_max",
            "max unclipped V-trace importance ratio of the last shard "
            "considered for ingest")
        c_refused = registry.counter(
            "flywheel_shards_refused_total",
            "shards refused by the ingest trust region (ρ-stats outside "
            "[1/trust, trust] / rho_max_cap)")
        c_ingested = registry.counter(
            "flywheel_shards_ingested_total",
            "shards accepted by the ingest trust region")
    accepted: "list[FlightShard]" = []
    per_shard: "list[dict]" = []
    for s in data.shards:
        stale = int(learner_step) - s.policy_step
        rho_mean, rho_max = shard_rho_stats(
            policy, s, example_obs, example_mask, example_act,
            env_params=env_params)
        ok = 1.0 / trust <= rho_mean <= trust and rho_max <= rho_max_cap
        if g_stale is not None:
            g_stale.set(stale)
            g_mean.set(rho_mean)
            g_max.set(rho_max)
            (c_ingested if ok else c_refused).inc()
        per_shard.append({"seq": s.seq, "rows": s.rows,
                          "staleness": stale, "rho_mean": rho_mean,
                          "rho_max": rho_max, "accepted": ok})
        if ok:
            accepted.append(s)
    report = IngestReport(
        shards_seen=len(data.shards), shards_accepted=len(accepted),
        shards_refused=len(data.shards) - len(accepted),
        rows_accepted=sum(s.rows for s in accepted),
        torn_tail=data.torn_tail, per_shard=per_shard)
    return accepted, report


def _fold_rows(flat: "list[np.ndarray]", T: int, E: int):
    return [l[:T * E].reshape(T, E, *l.shape[1:]) for l in flat]


def shards_to_transition(shards: "list[FlightShard]", n_envs: int,
                         tile: int, example_obs: Any, example_mask: Any,
                         example_act: Any, env_params=None,
                         device: "torch.device | str" = "cpu",
                         ) -> "tuple[Transition, torch.Tensor, int]":
    """Fold the accepted shards' rows into one ``[T, E]`` Transition on
    ``device`` (row ``t*E + e`` is step ``t``, lane ``e``). The rows that
    cannot fill a step, and any steps past the largest ``T`` whose
    ``T*E`` rows tile ``tile`` (the update's minibatch size or count),
    are dropped. The mask is the logged one with the serving stall gate
    re-applied (``env_params``). Returns ``(transition, last_value[E],
    T)``."""
    if not shards:
        raise FlightLogError("no shards survived the ingest trust region")
    E = int(n_envs)
    cat = lambda ls: [np.concatenate(x) for x in zip(*ls)]
    col = lambda k: np.concatenate([getattr(s, k) for s in shards])
    mask_rows = gate_logged_mask(
        unflatten_like(example_mask, cat([s.mask_leaves for s in shards])),
        col("stall"), env_params)
    lp, value, outcome = col("log_prob"), col("value"), col("outcome")
    rows = int(lp.shape[0])
    T = rows // E
    while T >= 2 and (T * E) % tile:
        T -= 1
    if T < 2:
        raise FlightLogError(
            f"{rows} ingested rows cannot form >= 2 pseudo-steps of "
            f"{E} lanes with a flattened batch tiling {tile}; log more "
            f"traffic or shrink n_envs / the minibatch geometry")
    fold = lambda like, flat: unflatten_like(like, _fold_rows(flat, T, E))
    head = lambda x: x[:T * E].reshape(T, E)
    tr = Transition(
        obs=fold(example_obs, cat([s.obs_leaves for s in shards])),
        action=fold(example_act, cat([s.act_leaves for s in shards])),
        log_prob=head(lp),
        value=head(value),
        reward=head(np.where(outcome == 2, -1.0, 1.0).astype(np.float32)),
        done=np.zeros((T, E), bool),
        mask=fold(example_mask, [np.asarray(x) for x in leaves(mask_rows)]),
        env_steps_dt=np.zeros((T, E), np.float32))
    dev = torch.device(device)
    # no successor observation exists for the final served rows: the
    # scan bootstraps from the last row batch's stored behavior value
    last_value = value[(T - 1) * E:T * E].astype(np.float32)
    return _put(tr, dev), _put(last_value, dev), T


def run_continual(exp, logdir: str, iterations: int = 1, *,
                  trust: float = 2.0, rho_max_cap: float = 8.0,
                  registry=None, ckpt=None) -> dict:
    """The continual-training loop: verify and admit the flight log once,
    then ``iterations`` V-trace-corrected learn steps over the folded
    pseudo-trajectories. ``exp`` is a built
    :class:`..experiment.Experiment` (its policy possibly restored); its
    train state advances in place, its update generator draws the
    minibatch permutations, and it is saved through ``ckpt`` (a
    :class:`..checkpoint.Checkpointer`) after every step when given.
    Returns the summary the CLI prints. A missing ``logdir`` reads as an
    empty log (JAX's reader raises ``FileNotFoundError`` there)."""
    data = (read_flight_log(logdir) if os.path.isdir(logdir)
            else FlightLogData(shards=[]))
    if not data.shards:
        raise FlightLogError(
            f"no verified shards under {logdir}"
            + (f" (torn tail: {data.torn_reason})" if data.torn_tail
               else ""))
    host = lambda t: tree_map(lambda x: x[:1].cpu().numpy(), t)
    ex_obs, ex_mask = host(exp.carry.obs), host(exp.carry.mask)
    with torch.no_grad():
        logits, _ = exp.net(exp.carry.obs, exp.carry.mask)
    ex_act = tree_map(lambda a: a[:1].to(torch.int32).cpu().numpy(),
                      greedy_actions(logits))
    accepted, report = admit_shards(
        data, exp.net, exp.step, ex_obs, ex_mask, ex_act, trust=trust,
        rho_max_cap=rho_max_cap, registry=registry,
        env_params=exp.env_params)
    algo = dataclasses.replace(exp.cfg.ppo, correction="vtrace")
    tile = (algo.minibatch_size if algo.minibatch_size is not None
            else algo.n_minibatches)
    tr, last_value, T = shards_to_transition(
        accepted, exp.cfg.n_envs, tile, ex_obs, ex_mask, ex_act,
        env_params=exp.env_params, device=exp.device)
    # the learn step flattens by n_steps: bind it to the folded T (the
    # data decides the geometry here, not the config)
    learn = make_learn_step(dataclasses.replace(algo, n_steps=T))
    metrics = None
    for _ in range(int(iterations)):
        exp.train_state, metrics = learn(exp.train_state, tr, last_value,
                                         exp.generator)
        if ckpt is not None:
            exp.save_checkpoint(ckpt)
    rows_trained = T * exp.cfg.n_envs
    summary = {
        "mode": "continual",
        "logdir": logdir,
        "iterations": int(iterations),
        "rows_logged": data.rows,
        "rows_accepted": report.rows_accepted,
        "rows_trained": rows_trained,
        "rows_dropped_fold": report.rows_accepted - rows_trained,
        "shards_seen": report.shards_seen,
        "shards_accepted": report.shards_accepted,
        "shards_refused": report.shards_refused,
        "torn_tail": report.torn_tail,
        "per_shard": report.per_shard,
        "pseudo_steps": T,
        "final_step": exp.step,
    }
    if metrics is not None:
        summary["rho_mean_trained"] = float(metrics.rho_mean)
        summary["rho_max_trained"] = float(metrics.rho_max)
        summary["total_loss"] = float(metrics.total_loss)
    return summary

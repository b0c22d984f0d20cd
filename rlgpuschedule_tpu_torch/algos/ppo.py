"""PPO trainer (L4) of the port: clipped surrogate, minibatch epochs,
entropy bonus, and the fused advantage pipeline's options.

Counterpart of the JAX package's ``algos/ppo.py``. There the whole
iteration (rollout scan, GAE scan, epoch x minibatch update scans) is one
jitted function; here it is the same three stages as eager PyTorch on
one device, with parameters and optimizer state updated in place.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr, eps=1e-5))``: :class:`ClippedAdam` clips by optax's rule (scale
by ``max_norm / g_norm`` only when ``g_norm >= max_norm``; torch's
``clip_grad_norm_`` adds 1e-6 to the norm and so differs) and then takes
``torch.optim.Adam``'s step, which computes optax's Adam update.

The advantage pipeline (:func:`compute_advantages`) is JAX's: streaming
reward normalization (Welford moments carried on the train state, scale
only), GAE or V-trace (``correction="vtrace"``: the ratios from one
batched forward under the learner's parameters), global normalization,
and optionally bf16 storage of the targets. ``bf16_update`` evaluates
the loss and its grads on bf16 casts of the parameters and the batch;
the grads come back in each parameter's dtype, so the optimizer's
moments stay f32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..env.env import EnvParams
from ..ops.gae import compute_gae
from ..sim.core import Trace
from . import action_dist
from . import vtrace as vtrace_ops
from .rollout import PolicyApply, RolloutCarry, Transition, rollout
from .update import cast_floating, run_minibatch_epochs, tree_map


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_steps: int = 128          # rollout length T per iteration
    # update geometry, validated against n_steps * n_envs by
    # algos.update.resolve_geometry; minibatch_size, when set, determines
    # the minibatch count and n_minibatches is ignored
    n_epochs: int = 4
    n_minibatches: int = 4
    minibatch_size: int | None = None
    bf16_update: bool = False
    correction: str = "none"    # "none" (GAE) or "vtrace"
    rho_bar: float = 1.0
    c_bar: float = 1.0
    reward_norm: bool = False
    bf16_advantages: bool = False
    gamma: float = 0.995
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5

    def __post_init__(self):
        if self.correction not in ("none", "vtrace"):
            raise ValueError(
                f"PPOConfig.correction must be 'none' or 'vtrace', "
                f"got {self.correction!r}")


class PPOMetrics(NamedTuple):
    total_loss: torch.Tensor
    pg_loss: torch.Tensor
    v_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    clip_frac: torch.Tensor
    mean_reward: torch.Tensor
    mean_value: torch.Tensor
    # importance-ratio stats of the V-trace path: 1.0 on the GAE path
    rho_mean: torch.Tensor
    rho_max: torch.Tensor


class ClippedAdam(torch.optim.Adam):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr,
    eps=1e-5))`` on the ``.grad`` of the parameters. The clip stays on
    the device: no host sync."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 max_grad_norm: float):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-5)
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdam.step takes no closure")
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        clip_by_global_norm_(grads, self.max_grad_norm)
        return super().step()


class ClippedRMSprop(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), rmsprop(lr,
    decay, eps))`` on the ``.grad`` of the parameters, A2C's optimizer.

    optax's ``rmsprop`` takes the eps inside the root (``eps_in_sqrt``)
    and starts its second moment at 0: ``nu = (1 - decay) g^2 + decay
    nu``, ``p -= lr * g * rsqrt(nu + eps)``. ``torch.optim.RMSprop``
    divides by ``sqrt(nu) + eps``, another update, so the step is written
    here. The state keeps ``nu`` and a ``step`` count (the train state's
    step; optax's rmsprop keeps no count). The clip stays on the device:
    no host sync."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 max_grad_norm: float, decay: float = 0.99,
                 eps: float = 1e-5):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedRMSprop.step takes no closure")
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        clip_by_global_norm_(grads, self.max_grad_norm)
        for group in self.param_groups:
            lr, decay, eps = group["lr"], group["decay"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                g, nu = p.grad, state["nu"]
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                p.add_(torch.rsqrt(nu + eps) * g, alpha=-lr)
                state["step"] += 1


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / g_norm`` where their
    global norm ``g_norm >= max_norm`` (optax's rule); returns
    ``g_norm``."""
    g_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    for g in grads:
        g.mul_(scale)
    return g_norm


def make_optimizer(config: PPOConfig,
                   params: Iterable[torch.Tensor]) -> ClippedAdam:
    return ClippedAdam(params, config.lr, config.max_grad_norm)


class RewardNormState(NamedTuple):
    """Welford running moments of the raw reward stream (f32 scalars on
    the device), carried on :class:`TrainState` when ``reward_norm`` is
    on."""
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def init_reward_stats(device: "torch.device | str | None" = None,
                      ) -> RewardNormState:
    return RewardNormState(*(torch.zeros((), dtype=torch.float32,
                                         device=device) for _ in range(3)))


def update_reward_stats(stats: RewardNormState,
                        rewards: torch.Tensor) -> RewardNormState:
    """The Chan/Welford parallel combine of the running moments with one
    rollout batch's."""
    r = rewards.to(torch.float32)
    batch_count = float(r.numel())
    batch_mean = torch.mean(r)
    batch_sq = torch.mean(r * r)
    batch_m2 = (batch_sq - batch_mean ** 2) * batch_count
    total = stats.count + batch_count
    delta = batch_mean - stats.mean
    new_mean = stats.mean + delta * batch_count / total
    new_m2 = (stats.m2 + batch_m2
              + delta ** 2 * stats.count * batch_count / total)
    return RewardNormState(count=total, mean=new_mean, m2=new_m2)


def reward_scale(stats: RewardNormState) -> torch.Tensor:
    """``1 / sqrt(running variance + 1e-8)``. Scale only: the rewards are
    not centered (a per-step baseline changes the optimal policy, a
    scale does not)."""
    var = stats.m2 / torch.clamp_min(stats.count, 1.0)
    return torch.rsqrt(var + 1e-8)


class TrainState(NamedTuple):
    """The policy and its optimizer, updated in place by a learn step,
    and the reward moments when ``reward_norm`` is on (JAX's
    ``NormTrainState``; None otherwise), replaced by each learn
    step."""
    net: nn.Module
    opt: torch.optim.Optimizer
    reward_stats: RewardNormState | None = None


def make_train_state(net: nn.Module, config: PPOConfig,
                     opt: torch.optim.Optimizer | None = None) -> TrainState:
    """The policy with ``opt`` (default: the config's clipped Adam) and,
    with ``config.reward_norm``, zeroed reward moments on the policy's
    device. A2C's state is built here too (``a2c.make_train_state``)."""
    stats = None
    if config.reward_norm:
        stats = init_reward_stats(next(net.parameters()).device)
    if opt is None:
        opt = make_optimizer(config, net.parameters())
    return TrainState(net, opt, stats)


def ppo_loss(apply_fn: PolicyApply, batch: Transition,
             advantages: torch.Tensor, returns: torch.Tensor,
             config: PPOConfig, clip_eps=None, ent_coef=None):
    """Returns ``(total, (pg_loss, v_loss, entropy, approx_kl,
    clip_frac))``. ``clip_eps`` and ``ent_coef`` default to the config's
    values; a population member passes its own (f32 scalar tensors on
    the batch's device, :mod:`..parallel.population`)."""
    clip_eps = config.clip_eps if clip_eps is None else clip_eps
    ent_coef = config.ent_coef if ent_coef is None else ent_coef
    logits, value = apply_fn(batch.obs, batch.mask)
    log_prob = action_dist.log_prob(logits, batch.action)
    ratio = torch.exp(log_prob - batch.log_prob)
    pg1 = ratio * advantages
    pg2 = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * advantages
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    # clipped value loss (PPO2-style trust region on the critic)
    v_clipped = batch.value + torch.clamp(value - batch.value,
                                          -clip_eps, clip_eps)
    v_loss = 0.5 * torch.mean(torch.maximum((value - returns) ** 2,
                                            (v_clipped - returns) ** 2))
    entropy = torch.mean(action_dist.entropy(logits))
    total = (pg_loss + config.vf_coef * v_loss
             - ent_coef * entropy)
    approx_kl = torch.mean(batch.log_prob - log_prob)
    clip_frac = torch.mean((torch.abs(ratio - 1.0) > clip_eps)
                           .to(torch.float32))
    return total, (pg_loss, v_loss, entropy, approx_kl, clip_frac)


def normalize_advantages(advantages: torch.Tensor) -> torch.Tensor:
    """Normalize over the whole batch. The variance is E[x^2] - E[x]^2,
    the form the JAX package reduces across devices."""
    adv_mean = torch.mean(advantages)
    adv_sq = torch.mean(advantages ** 2)
    adv_var = adv_sq - adv_mean ** 2
    return (advantages - adv_mean) / torch.sqrt(adv_var + 1e-8)


def compute_advantages(config: PPOConfig, state: TrainState,
                       tr: Transition, last_value: torch.Tensor):
    """The advantage pipeline: reward normalization (``reward_norm``),
    GAE or V-trace, global normalization, optional bf16 storage
    (``bf16_advantages``). Returns ``(state, advantages, returns,
    rho_stats)``: ``state`` carries the updated reward moments,
    ``rho_stats`` is ``(mean, max)`` of the unclipped importance ratios
    under ``correction="vtrace"`` and None on the GAE path. With the
    default config this is GAE and the normalization alone."""
    rewards = tr.reward
    if config.reward_norm:
        stats = update_reward_stats(state.reward_stats, rewards)
        rewards = rewards * reward_scale(stats)
        state = state._replace(reward_stats=stats)
    rho_stats = None
    if config.correction == "vtrace":
        T, E = tr.reward.shape[:2]
        flat = lambda t: tree_map(lambda x: x.reshape(T * E, *x.shape[2:]),
                                  t)
        # one batched forward under the learner's parameters; on-policy
        # data gives ratios of exactly 1.0 only where these [T*E] logits
        # are row-equal to the rollout's per-step [E] ones (the values
        # bootstrap the stored behaviour values, as in JAX)
        with torch.no_grad():
            logits, _ = state.net(flat(tr.obs), flat(tr.mask))
            target_lp = action_dist.log_prob(
                logits, flat(tr.action)).reshape(T, E)
        rho = vtrace_ops.importance_ratios(tr.log_prob, target_lp)
        advantages, returns = vtrace_ops.compute_vtrace(
            rewards, tr.value, tr.done, last_value, rho, config.gamma,
            config.gae_lambda, config.rho_bar, config.c_bar)
        rho_stats = (torch.mean(rho), torch.max(rho))
    else:
        advantages, returns = compute_gae(rewards, tr.value, tr.done,
                                          last_value, config.gamma,
                                          config.gae_lambda)
    advantages = normalize_advantages(advantages)
    if config.bf16_advantages:
        advantages = advantages.to(torch.bfloat16)
        returns = returns.to(torch.bfloat16)
    return state, advantages, returns, rho_stats


def loss_and_backward(loss_fn, net: nn.Module, mb: Transition,
                      adv: torch.Tensor, ret: torch.Tensor, config,
                      bf16_update: bool, **loss_kw):
    """Evaluate ``loss_fn(apply, mb, adv, ret, config) -> (loss, aux)``
    and backpropagate into ``net``'s ``.grad``. With ``bf16_update`` the
    loss runs on bf16 casts of the parameters and of the batch's
    floating tensors, and the cast's backward returns each grad in its
    parameter's dtype (JAX casts the bf16 grads back the same way)."""
    if bf16_update:
        params = {n: p.to(torch.bfloat16)
                  for n, p in net.named_parameters()}
        apply = lambda obs, mask: functional_call(net, params, (obs, mask))
        mb, adv, ret = cast_floating((mb, adv, ret), torch.bfloat16)
    else:
        apply = net
    loss, aux = loss_fn(apply, mb, adv, ret, config, **loss_kw)
    loss.backward()
    return (loss.detach().to(torch.float32),
            *(a.detach().to(torch.float32) for a in aux))


def make_ppo_grad_step(config: PPOConfig, clip_eps=None, ent_coef=None):
    """One clipped-surrogate update on one minibatch for the update
    engine: ``(state, (mb, adv, ret)) -> (state, (loss, *aux))``;
    ``clip_eps`` and ``ent_coef`` as :func:`ppo_loss`'s."""

    def grad_step(state: TrainState, mb_data):
        mb, adv, ret = mb_data
        state.opt.zero_grad(set_to_none=True)
        stats = loss_and_backward(ppo_loss, state.net, mb, adv, ret, config,
                                  config.bf16_update, clip_eps=clip_eps,
                                  ent_coef=ent_coef)
        state.opt.step()
        return state, stats

    return grad_step


def run_ppo_epochs(config: PPOConfig, state: TrainState, tr: Transition,
                   advantages: torch.Tensor, returns: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None,
                   rho_stats: tuple | None = None, clip_eps=None,
                   ent_coef=None) -> tuple[TrainState, PPOMetrics]:
    """Flatten ``[T, E]`` to ``[B]`` and run the config's
    ``n_epochs x n_minibatches`` geometry through the update engine
    (permutations from ``generator``, or ``perms``); ``clip_eps`` and
    ``ent_coef`` as :func:`ppo_loss`'s."""
    B = tr.reward.shape[0] * tr.reward.shape[1]
    flat = tree_map(lambda x: x.reshape(B, *x.shape[2:]), tr)
    state, stats = run_minibatch_epochs(
        make_ppo_grad_step(config, clip_eps, ent_coef), state,
        (flat, advantages.reshape(B), returns.reshape(B)),
        generator=generator, perms=perms, n_epochs=config.n_epochs,
        n_minibatches=config.n_minibatches,
        minibatch_size=config.minibatch_size)
    if rho_stats is None:
        one = torch.ones((), dtype=torch.float32, device=tr.reward.device)
        rho_stats = (one, one)
    metrics = PPOMetrics(
        total_loss=stats[0].mean(), pg_loss=stats[1].mean(),
        v_loss=stats[2].mean(), entropy=stats[3].mean(),
        approx_kl=stats[4].mean(), clip_frac=stats[5].mean(),
        mean_reward=tr.reward.mean(), mean_value=tr.value.mean(),
        rho_mean=rho_stats[0], rho_max=rho_stats[1])
    return state, metrics


LearnStep = Callable[..., tuple[TrainState, PPOMetrics]]


def make_learn_step(config: PPOConfig) -> LearnStep:
    """The learn half of the iteration:
    ``(state, tr, last_value, generator=None, perms=None) -> (state,
    metrics)``: the advantage pipeline, then the minibatch epochs."""

    def learn_step(state: TrainState, tr: Transition,
                   last_value: torch.Tensor,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None):
        state, advantages, returns, rho_stats = compute_advantages(
            config, state, tr, last_value)
        return run_ppo_epochs(config, state, tr, advantages, returns,
                              generator=generator, perms=perms,
                              rho_stats=rho_stats)

    return learn_step


def make_train_step(env_params: EnvParams, config: PPOConfig):
    """One PPO iteration: ``(state, carry, traces, generator[, faults])
    -> (state, carry', metrics)``, the rollout under ``faults`` (None: a
    healthy cluster); the rollout samples from the carry's generator,
    the update permutes with ``generator``."""
    learn_step = make_learn_step(config)

    def train_step(state: TrainState, carry: RolloutCarry, traces: Trace,
                   generator: torch.Generator, faults=None):
        carry, tr, last_value = rollout(state.net, env_params, traces,
                                        carry, config.n_steps,
                                        faults=faults)
        state, metrics = learn_step(state, tr, last_value, generator)
        return state, carry, metrics

    return train_step

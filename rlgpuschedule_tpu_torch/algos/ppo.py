"""PPO trainer (L4) of the port: clipped surrogate, minibatch epochs,
entropy bonus.

Counterpart of the JAX package's ``algos/ppo.py``. There the whole
iteration (rollout scan, GAE scan, epoch x minibatch update scans) is one
jitted function; here it is the same three stages as eager PyTorch on
one device, with parameters and optimizer state updated in place.

The optimizer is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr, eps=1e-5))``: :class:`ClippedAdam` clips by optax's rule (scale
by ``max_norm / g_norm`` only when ``g_norm >= max_norm``; torch's
``clip_grad_norm_`` adds 1e-6 to the norm and so differs) and then takes
``torch.optim.Adam``'s step, which computes optax's Adam update.

The off-policy correction (``correction="vtrace"``), streaming reward
normalization and the bf16 update/advantage paths keep their config
fields; a non-default value raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Sequence

import torch
from torch import nn

from ..env.env import EnvParams
from ..ops.gae import compute_gae
from ..sim.core import Trace
from . import action_dist
from .rollout import PolicyApply, RolloutCarry, Transition, rollout
from .update import run_minibatch_epochs, tree_map

_LATER = ("waits for the off-policy and precision slice (ROADMAP.md "
          "queue 1, item 18)")


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
        for name in ("bf16_update", "reward_norm", "bf16_advantages"):
            if getattr(self, name):
                raise NotImplementedError(f"PPOConfig.{name}=True {_LATER}")
        if self.correction == "vtrace":
            raise NotImplementedError(f"PPOConfig.correction='vtrace' "
                                      f"{_LATER}")


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


class TrainState(NamedTuple):
    """The policy and its optimizer, updated in place by a learn step."""
    net: nn.Module
    opt: torch.optim.Optimizer


def make_train_state(net: nn.Module, config: PPOConfig) -> TrainState:
    return TrainState(net, make_optimizer(config, net.parameters()))


def ppo_loss(apply_fn: PolicyApply, batch: Transition,
             advantages: torch.Tensor, returns: torch.Tensor,
             config: PPOConfig):
    """Returns ``(total, (pg_loss, v_loss, entropy, approx_kl,
    clip_frac))``."""
    clip_eps = config.clip_eps
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
             - config.ent_coef * entropy)
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


def compute_advantages(config: PPOConfig, tr: Transition,
                       last_value: torch.Tensor,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE on the behaviour values, then global normalization of the
    advantages. Returns ``(advantages, returns)``, each ``[T, E]``."""
    advantages, returns = compute_gae(tr.reward, tr.value, tr.done,
                                      last_value, config.gamma,
                                      config.gae_lambda)
    return normalize_advantages(advantages), returns


def make_ppo_grad_step(config: PPOConfig):
    """One clipped-surrogate update on one minibatch for the update
    engine: ``(state, (mb, adv, ret)) -> (state, (loss, *aux))``."""

    def grad_step(state: TrainState, mb_data):
        mb, adv, ret = mb_data
        loss, aux = ppo_loss(state.net, mb, adv, ret, config)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        return state, (loss.detach(), *(a.detach() for a in aux))

    return grad_step


def run_ppo_epochs(config: PPOConfig, state: TrainState, tr: Transition,
                   advantages: torch.Tensor, returns: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None,
                   ) -> tuple[TrainState, PPOMetrics]:
    """Flatten ``[T, E]`` to ``[B]`` and run the config's
    ``n_epochs x n_minibatches`` geometry through the update engine
    (permutations from ``generator``, or ``perms``)."""
    B = tr.reward.shape[0] * tr.reward.shape[1]
    flat = tree_map(lambda x: x.reshape(B, *x.shape[2:]), tr)
    state, stats = run_minibatch_epochs(
        make_ppo_grad_step(config), state,
        (flat, advantages.reshape(B), returns.reshape(B)),
        generator=generator, perms=perms, n_epochs=config.n_epochs,
        n_minibatches=config.n_minibatches,
        minibatch_size=config.minibatch_size)
    one = torch.ones((), dtype=torch.float32, device=tr.reward.device)
    metrics = PPOMetrics(
        total_loss=stats[0].mean(), pg_loss=stats[1].mean(),
        v_loss=stats[2].mean(), entropy=stats[3].mean(),
        approx_kl=stats[4].mean(), clip_frac=stats[5].mean(),
        mean_reward=tr.reward.mean(), mean_value=tr.value.mean(),
        rho_mean=one, rho_max=one)
    return state, metrics


LearnStep = Callable[..., tuple[TrainState, PPOMetrics]]


def make_learn_step(config: PPOConfig) -> LearnStep:
    """The learn half of the iteration:
    ``(state, tr, last_value, generator=None, perms=None) -> (state,
    metrics)``: GAE, advantage normalization, the minibatch epochs."""

    def learn_step(state: TrainState, tr: Transition,
                   last_value: torch.Tensor,
                   generator: torch.Generator | None = None,
                   perms: Sequence[torch.Tensor] | None = None):
        advantages, returns = compute_advantages(config, tr, last_value)
        return run_ppo_epochs(config, state, tr, advantages, returns,
                              generator=generator, perms=perms)

    return learn_step


def make_train_step(env_params: EnvParams, config: PPOConfig):
    """One PPO iteration:
    ``(state, carry, traces, generator) -> (state, carry', metrics)``;
    the rollout samples from the carry's generator, the update permutes
    with ``generator``."""
    learn_step = make_learn_step(config)

    def train_step(state: TrainState, carry: RolloutCarry, traces: Trace,
                   generator: torch.Generator):
        carry, tr, last_value = rollout(state.net, env_params, traces,
                                        carry, config.n_steps)
        state, metrics = learn_step(state, tr, last_value, generator)
        return state, carry, metrics

    return train_step

"""PPO for abstention fine-tuning (phase 2).

Port of linnaeus_tpu/rl/ppo.py (reference parity: rl_train_abstention.py:
38-531): GAE advantage estimation and the clipped-surrogate PPO update,
plus a rollout/update loop over the multitask abstention environment.
The update is one forward and backward over the whole rollout and one step
of ``torch.optim.Adam(lr, eps=1e-8)`` over every parameter, the backbone
included: ``optax.adam(lr)`` with the same bias correction.

The rollout calls the policy on one image at a time; the update runs the
rollout as one batch (``PPOConfig.epochs`` times an iteration), every call
in eval mode (no dropout or drop path), as JAX passes
``deterministic=True``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from linnaeus_tpu_torch.utils import tracing
from linnaeus_tpu_torch.utils.logging import get_main_logger

logger = get_main_logger()


def compute_gae_and_returns(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    last_value: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation (rl_train_abstention.py:38); copied
    from the JAX package."""
    T = len(rewards)
    advantages = np.zeros(T, dtype=np.float32)
    gae = 0.0
    for t in reversed(range(T)):
        next_value = last_value if t == T - 1 else values[t + 1]
        next_nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_value * next_nonterminal - values[t]
        gae = delta + gamma * gae_lambda * next_nonterminal * gae
        advantages[t] = gae
    returns = advantages + values
    return advantages, returns


class PPOConfig(NamedTuple):
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gamma: float = 0.99
    gae_lambda: float = 0.95
    epochs: int = 4
    lr: float = 3e-5


def make_adam(parameters, cfg: PPOConfig) -> torch.optim.Adam:
    """``optax.adam(cfg.lr)``: betas (0.9, 0.999), eps 1e-8 outside the
    square root, no weight decay."""
    return torch.optim.Adam(parameters, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def make_ppo_update(policy_apply: Callable, optimizer: torch.optim.Optimizer,
                    cfg: PPOConfig):
    """policy_apply(images, aux, actions) -> (log_prob, entropy, value).

    Returns ``update(batch) -> metrics``: one gradient of the clipped
    surrogate objective (rl_train_abstention.py:57-120) at the current
    parameters and one optimizer step; the metrics are 0-d tensors taken
    before the step, as JAX's ``value_and_grad`` gives them.
    """

    def loss_fn(batch):
        log_prob, entropy, value = policy_apply(
            batch["images"], batch.get("aux"), batch["actions"]
        )
        ratio = torch.exp(log_prob - batch["old_log_prob"])
        adv = batch["advantages"]
        # jnp.std is the population std (ddof 0); torch.std defaults to Bessel's
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        policy_loss = -torch.minimum(surr1, surr2).mean()
        value_loss = (value - batch["returns"]).square().mean()
        entropy_bonus = entropy.mean()
        total = (
            policy_loss
            + cfg.value_coef * value_loss
            - cfg.entropy_coef * entropy_bonus
        )
        return total, {
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy_bonus,
            "approx_kl": (batch["old_log_prob"] - log_prob).mean(),
        }

    def update(batch):
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch)
        total.backward()
        optimizer.step()
        metrics["total_loss"] = total
        return {k: v.detach() for k, v in metrics.items()}

    return update


def _stack(items) -> torch.Tensor:
    return torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in items])


def collect_rollout(env, act_fn: Callable, num_steps: int):
    """Roll the multitask env; act_fn(obs, info) -> (actions dict, log_prob,
    value). Returns the rollout: ``images`` and ``aux`` stacked as float32
    tensors where the observations lie (the device, from the port's
    provider), the rest as numpy arrays."""
    obs_images, obs_aux, acts, log_probs, values, rewards, dones = (
        [], [], [], [], [], [], [],
    )
    obs, info = env.reset()
    for _ in range(num_steps):
        actions, log_prob, value = act_fn(obs, info)
        next_obs, reward, done, truncated, next_info = env.step(
            np.asarray([actions[t] for t in env.rank_order])
        )
        obs_images.append(obs["image"])
        obs_aux.append(info.get("aux"))
        acts.append([actions[t] for t in env.rank_order])
        log_probs.append(log_prob)
        values.append(value)
        rewards.append(reward)
        dones.append(done)
        if done or truncated:
            obs, info = env.reset()
        else:
            obs, info = next_obs, next_info
    return {
        "images": _stack(obs_images),
        "aux": (
            _stack([a if a is not None else np.zeros(0) for a in obs_aux])
            if obs_aux[0] is not None
            else None
        ),
        "actions": np.asarray(acts, np.int64),  # (T, num_ranks)
        "old_log_prob": np.asarray(log_probs, np.float32),
        "values": np.asarray(values, np.float32),
        "rewards": np.asarray(rewards, np.float32),
        "dones": np.asarray(dones, bool),
    }


def train_abstention_ppo(
    policy,
    env,
    cfg: PPOConfig = PPOConfig(),
    num_iterations: int = 10,
    steps_per_rollout: int = 64,
    generator: torch.Generator | None = None,
    optimizer: torch.optim.Optimizer | None = None,
    timings: list | None = None,
):
    """The phase-2 loop (rl_train_abstention.py main loop) on ``policy``
    (a LinnaeusPolicyWrapper), which it updates in place. Actions are drawn
    from ``generator`` (on the policy's device; seed 0 when None). Returns
    ``(policy, history)``: one record an iteration, the mean reward and the
    last update's metrics, as in JAX. ``timings``, when given, gets one
    record an iteration too: the rollout's milliseconds an action (host
    clock: every action is read back to the host) and the update's
    milliseconds an epoch (CUDA events on the card, else the host clock),
    from the ``ppo/rollout`` and ``ppo/update`` spans (utils/tracing.py)."""
    from .policies import sample_actions

    device = next(policy.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    optimizer = optimizer if optimizer is not None else make_adam(policy.parameters(), cfg)
    task_keys = tuple(env.rank_order)
    policy.eval()

    def act_fn(obs, info):
        images = torch.as_tensor(obs["image"], device=device)[None]
        aux = info.get("aux")
        aux = torch.as_tensor(aux, device=device)[None] if aux is not None else None
        with torch.no_grad():
            logits, value = policy(images, aux)
            actions, log_prob = sample_actions(logits, generator)
            # one copy to the host an action
            host = torch.cat([torch.stack([actions[t][0] for t in task_keys]).double(),
                              log_prob[:1].double(), value[:1].double()]).cpu().numpy()
        return (
            {t: int(host[i]) for i, t in enumerate(task_keys)},
            float(host[-2]),
            float(host[-1]),
        )

    def eval_actions(images, aux, actions_arr):
        actions = {t: actions_arr[:, i] for i, t in enumerate(task_keys)}
        return policy.evaluate_actions(images, aux, actions)

    update = make_ppo_update(eval_actions, optimizer, cfg)
    on_card = device.type == "cuda"

    history = []
    for it in range(num_iterations):
        with tracing.span("ppo/rollout", always=True):
            rollout = collect_rollout(env, act_fn, steps_per_rollout)
        adv, ret = compute_gae_and_returns(
            rollout["rewards"], rollout["values"], rollout["dones"],
            cfg.gamma, cfg.gae_lambda,
        )
        batch = {
            "images": rollout["images"].to(device),
            "aux": rollout["aux"].to(device) if rollout["aux"] is not None else None,
            "actions": torch.as_tensor(rollout["actions"], device=device),
            "old_log_prob": torch.as_tensor(rollout["old_log_prob"], device=device),
            "advantages": torch.as_tensor(adv, device=device),
            "returns": torch.as_tensor(ret, device=device),
        }
        with tracing.span("ppo/update", always=True):
            for _ in range(cfg.epochs):
                metrics = update(batch)
        (rollout_span,), (update_span,) = tracing.take("ppo/rollout"), tracing.take("ppo/update")
        rollout_ms = 1000.0 * (rollout_span.end - rollout_span.start) / steps_per_rollout
        update_ms = (update_span.device_ms if on_card else
                     1000.0 * (update_span.end - update_span.start)) / cfg.epochs
        mean_reward = float(rollout["rewards"].mean())
        history.append({"iteration": it, "mean_reward": mean_reward,
                        **{k: float(v) for k, v in metrics.items()}})
        if timings is not None:
            timings.append({"rollout_ms_per_action": rollout_ms,
                            "update_ms_per_epoch": update_ms})
        logger.info(
            f"PPO iter {it}: reward {mean_reward:.3f} "
            f"kl {history[-1]['approx_kl']:.4f}"
        )
    return policy, history

"""Phase-2 abstention fine-tuning CLI.

Port of linnaeus_tpu/rl/train_abstention.py (reference parity:
linnaeus/rl_train_abstention.py:38-531): load a phase-1 checkpoint of the
port's Trainer, wrap the model in an actor-critic policy, build the
abstention environment over the training data, and run PPO.

``--eval-samples N`` measures greedy-policy abstention precision/recall on
N held-out (validation) samples before and after PPO; ``--receipt out.json``
writes the reward curve and both evals. The policy is saved as
``<checkpoints>/abstention_policy.pt`` (its state_dict). The phase-1
checkpoint is a port checkpoint directory (``state/state.pt``); the JAX
package's Orbax directory raises by name. It runs on the CUDA device
unless ``--device cpu`` is given; without a card and without that flag it
raises.

Usage:
    python -m linnaeus_tpu_torch.rl.train_abstention --cfg exp.yaml \\
        --checkpoint /path/to/checkpoints [--iterations 50] \\
        [--eval-samples 512 --receipt rl_abstention.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


def warm_start_actor_heads(policy, backbone_state: dict, task_keys,
                           logger=None) -> list[str]:
    """Copy each phase-1 Linear classification head (``head.<task>.fc`` of
    the phase-1 model's state_dict) into the matching actor head's class
    rows, keeping the abstain row and bias from init (the abstain prior).
    A fresh actor must re-learn classification through the policy gradient
    and converges to the all-abstain optimum instead.

    Returns the warmed task keys. Heads whose geometry does not match
    (other head types, another class count, no bias) are left untouched."""
    warmed: list[str] = []
    for t in task_keys:
        k = backbone_state.get(f"head.{t}.fc.weight")
        b = backbone_state.get(f"head.{t}.fc.bias")
        actor = getattr(policy, f"actor_{t}", None)
        if actor is None or k is None or b is None:
            continue
        ak = actor.weight  # (n_cls + 1, feat)
        if k.ndim == 2 and k.shape[1] == ak.shape[1] and k.shape[0] == ak.shape[0] - 1:
            with torch.no_grad():
                actor.weight[:-1].copy_(k.to(ak.dtype))
                actor.bias[:-1].copy_(b.to(actor.bias.dtype))
            warmed.append(t)
            if logger is not None:
                logger.info(
                    f"Actor head actor_{t} warm-started from the phase-1 "
                    f"classifier ({k.shape[0]} classes + abstain)"
                )
    return warmed


def load_backbone(model, state: dict, logger=None) -> list[str]:
    """Load a phase-1 model's state_dict into ``model``: every tensor but
    the classification heads must match. A head whose class count differs
    (a dataset with other taxa) is skipped and named: the policy never
    calls the backbone's heads, only ``forward_features``, as the JAX
    package replaces the whole backbone tree. Returns the skipped keys."""
    own = model.state_dict()
    skipped = [k for k, v in state.items()
               if k.startswith("head.") and k in own and own[k].shape != v.shape]
    missing, unexpected = model.load_state_dict(
        {k: v for k, v in state.items() if k not in skipped}, strict=False)
    if unexpected or set(missing) != set(skipped):
        raise ValueError(
            f"the phase-1 checkpoint does not fit the model: missing "
            f"{sorted(set(missing) - set(skipped))}, unexpected {sorted(unexpected)}")
    if skipped and logger is not None:
        logger.warning(f"Phase-1 heads of another class count left out: {skipped}")
    return skipped


def evaluate_abstention(policy, loader, task_keys, num_classes,
                        max_samples: int, null_index: int = 0) -> dict:
    """Greedy (argmax) policy metrics on a held-out loader.

    Abstention is scored at the leaf rank (task_keys[0], the finest level):
    treating "abstain" as the positive class against null-labeled ground
    truth gives precision/recall; accuracy-when-committing covers the
    non-null rows the policy chose to classify."""
    from .provider import _host, normalize_images

    leaf = task_keys[0]
    device = next(policy.parameters()).device
    policy.eval()

    stats = {
        t: dict(tp=0, fp=0, fn=0, committed_correct=0, committed_known=0,
                n_null=0)
        for t in task_keys
    }
    seen = 0
    p_abst_null: list[float] = []
    p_abst_known: list[float] = []

    for batch in loader:
        im = normalize_images(batch["images"]).to(device)
        aux = batch.get("aux")
        aux = torch.as_tensor(aux, device=device) if aux is not None else None
        with torch.no_grad():
            logits, _ = policy(im, aux)
            acts_all = {t: _host(logits[t].argmax(-1)) for t in task_keys}
            # P(abstain) at the leaf: the continuous selectivity readout
            p_abst = _host(torch.softmax(logits[leaf], dim=-1)[:, -1])
        leaf_tgt = _host(batch["targets"][leaf])
        leaf_idx = leaf_tgt.argmax(-1) if leaf_tgt.ndim > 1 else leaf_tgt
        p_abst_null.extend(p_abst[leaf_idx == null_index].tolist())
        p_abst_known.extend(p_abst[leaf_idx != null_index].tolist())
        for t in task_keys:
            if t not in batch["targets"]:
                continue
            n_t = int(num_classes[t])
            tgt = _host(batch["targets"][t])
            t_idx = tgt.argmax(-1) if tgt.ndim > 1 else tgt
            acts = acts_all[t]
            is_null = t_idx == null_index
            abstain = acts >= n_t  # the explicit abstain action
            s = stats[t]
            s["tp"] += int((abstain & is_null).sum())
            s["fp"] += int((abstain & ~is_null).sum())
            s["fn"] += int((~abstain & is_null).sum())
            commit_known = ~abstain & ~is_null
            s["committed_known"] += int(commit_known.sum())
            s["committed_correct"] += int(
                (acts[commit_known] == t_idx[commit_known]).sum()
            )
            s["n_null"] += int(is_null.sum())
        seen += im.shape[0]
        if seen >= max_samples:
            break

    def _summ(s):
        return {
            "abstain_rate": round((s["tp"] + s["fp"]) / max(seen, 1), 4),
            "abstain_precision": round(s["tp"] / max(s["tp"] + s["fp"], 1), 4),
            "abstain_recall": round(s["tp"] / max(s["tp"] + s["fn"], 1), 4),
            "acc_when_committing_on_known": round(
                s["committed_correct"] / max(s["committed_known"], 1), 4
            ),
        }

    return {
        "samples": seen,
        "null_samples": stats[leaf]["n_null"],
        **_summ(stats[leaf]),  # leaf metrics at top level (stable keys)
        "mean_p_abstain_on_null": round(float(np.mean(p_abst_null)), 4)
        if p_abst_null else None,
        "mean_p_abstain_on_known": round(float(np.mean(p_abst_known)), 4)
        if p_abst_known else None,
        "per_rank": {t: _summ(stats[t]) for t in task_keys},
    }


def parse_args(argv=None):
    parser = argparse.ArgumentParser("train_abstention")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="phase-1 checkpoint dir (auto-resume dir if unset)")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--rollout-steps", type=int, default=128)
    parser.add_argument("--mode", default="multitask",
                        choices=["multitask", "sequential"])
    parser.add_argument("--no-actor-warm-start", action="store_true",
                        help="keep fresh random actor heads instead of "
                             "copying the phase-1 classification heads")
    parser.add_argument("--lr", type=float, default=None,
                        help="PPO learning rate (default PPOConfig.lr; "
                             "fresh actor heads on a frozen-quality "
                             "backbone usually want 1e-4..3e-4)")
    parser.add_argument("--entropy-coef", type=float, default=None,
                        help="PPO entropy bonus (default PPOConfig)")
    parser.add_argument("--abstain-prior", type=float, default=0.0,
                        help="initial probability mass on the abstain "
                             "action (exploration prior; see "
                             "rl/policies.py)")
    parser.add_argument("--eval-samples", type=int, default=0,
                        help="held-out samples for before/after abstention "
                             "precision/recall (0 = skip)")
    parser.add_argument("--receipt", default="",
                        help="write reward curve + evals to this JSON")
    parser.add_argument("--opts", nargs="*", default=None)
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (default; raises without a card), "cuda:N" or "cpu"')
    return parser.parse_args(argv)


@dataclass
class AbstentionRun:
    """What ``run`` leaves: the trained policy, its environment (over the
    open train loader), the loaders, the PPO history and timings (see
    ``train_abstention_ppo``), the receipt and the saved policy's path.
    ``close`` stops the loaders."""

    policy: Any
    env: Any
    train_loader: Any
    val_loader: Any
    history: list = field(default_factory=list)
    timings: list = field(default_factory=list)
    receipt: dict = field(default_factory=dict)
    policy_path: str = ""

    def close(self) -> None:
        for loader in (self.train_loader, self.val_loader):
            if loader is not None:
                loader.close()


def run(argv=None) -> AbstentionRun:
    """Everything ``main`` does, the loaders left open."""
    args = parse_args(argv)

    from linnaeus_tpu_torch.configuration import build_config
    from linnaeus_tpu_torch.configuration.utils import setup_output_dirs
    from linnaeus_tpu_torch.data.build import build_datasets, build_loaders
    from linnaeus_tpu_torch.models.build import build_model
    from linnaeus_tpu_torch.rl import (
        LinnaeusPolicyWrapper,
        PPOConfig,
        TaxonomicClassificationEnv,
        train_abstention_ppo,
    )
    from linnaeus_tpu_torch.utils import checkpoint as ckpt
    from linnaeus_tpu_torch.utils.device import describe_device, resolve_device
    from linnaeus_tpu_torch.utils.logging import create_logger, get_main_logger

    config = build_config(args.cfg, opts=args.opts)
    config.freeze()
    device = resolve_device(None if args.device == "cuda" else args.device)
    setup_output_dirs(config)
    create_logger(config.ENV.OUTPUT.DIRS.LOGS)
    logger = get_main_logger()

    bundle = build_datasets(config)
    train_loader, val_loader = build_loaders(config, bundle, device=device)
    tree = bundle["taxonomy_tree"]
    img = config.MODEL.IMG_SIZE
    hw = (img, img) if isinstance(img, int) else tuple(img)

    model = build_model(config, bundle["num_classes"], tree, device=device, seed=0)
    task_keys = tuple(config.DATA.TASK_KEYS_H5)
    policy = LinnaeusPolicyWrapper(
        model, task_keys, bundle["num_classes"],
        abstain_prior=float(args.abstain_prior),
        generator=torch.Generator().manual_seed(0),
    )

    # warm-start the backbone from a phase-1 checkpoint
    ckpt_dir = args.checkpoint or config.ENV.OUTPUT.DIRS.CHECKPOINTS
    latest = ckpt_dir if os.path.basename(ckpt_dir.rstrip("/")).startswith(
        "checkpoint_step_"
    ) else ckpt.auto_resume_helper(ckpt_dir)
    if latest:
        backbone_state = ckpt.read_model_state(latest)
        load_backbone(model, backbone_state, logger)
        logger.info(f"Warm-started backbone from {latest}")
        if not args.no_actor_warm_start:
            warm_start_actor_heads(policy, backbone_state, task_keys, logger)
    else:
        logger.warning("No phase-1 checkpoint found; training policy from scratch")

    env = TaxonomicClassificationEnv(
        dataloader=train_loader,
        taxonomy_tree=tree,
        mode=args.mode,
        image_shape=(*hw, 3),
    )
    result = AbstentionRun(policy, env, train_loader, val_loader)
    eval_before = eval_after = None
    if args.eval_samples > 0 and val_loader is not None:
        eval_before = evaluate_abstention(
            policy, val_loader, task_keys, bundle["num_classes"], args.eval_samples,
        )
        logger.info(f"abstention eval BEFORE PPO: {eval_before}")
    ppo_cfg = PPOConfig()
    if args.lr is not None:
        ppo_cfg = ppo_cfg._replace(lr=float(args.lr))
    if args.entropy_coef is not None:
        ppo_cfg = ppo_cfg._replace(entropy_coef=float(args.entropy_coef))
    _, history = train_abstention_ppo(
        policy, env,
        cfg=ppo_cfg,
        num_iterations=args.iterations,
        steps_per_rollout=args.rollout_steps,
        generator=torch.Generator(device=device).manual_seed(0),
        timings=result.timings,
    )
    result.history = history
    if args.eval_samples > 0 and val_loader is not None:
        eval_after = evaluate_abstention(
            policy, val_loader, task_keys, bundle["num_classes"], args.eval_samples,
        )
        logger.info(f"abstention eval AFTER PPO: {eval_after}")
    out = f"{config.ENV.OUTPUT.DIRS.CHECKPOINTS}/abstention_policy.pt"
    torch.save(policy.state_dict(), out)
    result.policy_path = out
    logger.info(f"Saved abstention policy to {out}")
    device_name, backend = describe_device() if device.type == "cuda" else ("cpu", "cpu")
    result.receipt = {
        "device": device_name,
        "backend": backend,
        "mode": args.mode,
        "iterations": args.iterations,
        "steps_per_rollout": args.rollout_steps,
        "abstain_prior": args.abstain_prior,
        "warm_start": latest or None,
        "reward_curve": [
            [h["iteration"], round(h["mean_reward"], 4)] for h in history
        ],
        "reward_first": round(history[0]["mean_reward"], 4)
        if history else None,
        "reward_last": round(history[-1]["mean_reward"], 4)
        if history else None,
        "ppo_metrics_last": {
            k: round(v, 5) for k, v in history[-1].items()
            if k != "iteration"
        } if history else None,
        "eval_before": eval_before,
        "eval_after": eval_after,
    }
    if args.receipt:
        os.makedirs(os.path.dirname(args.receipt) or ".", exist_ok=True)
        with open(args.receipt, "w") as f:
            json.dump(result.receipt, f, indent=1)
        logger.info(f"Wrote RL receipt to {args.receipt}")
    return result


def main(argv=None) -> AbstentionRun:
    result = run(argv)
    result.close()
    return result


if __name__ == "__main__":
    main()

"""Gymnasium environment for taxonomic classification with abstention.

Copy of linnaeus_tpu/rl/env.py, with its fallback for a missing
gymnasium (a plain base class, no spaces). One change: an observation
image that is a torch tensor (the port's provider hands over device
tensors) stays a tensor, cast to float32 where it lies; anything else
becomes a float32 numpy array as in the JAX package.

Reference parity: rl_env/environment.py:16-442. Two modes:
  * ``sequential``: one decision per rank, fine->coarse over task_keys; the
    action space is Discrete(max_classes + 1) with the last index = abstain.
  * ``multitask``: all ranks at once via MultiDiscrete([n_c+1 per rank]).

Observations: dict(image [H,W,C] float32, current_rank_index in sequential
mode). Rewards come from the verifier at episode end (sequential mode scores
once after the last rank; per-step reward is 0 until then, matching the
reference's episode-level verifier call).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces

    _GYM = True
except ImportError:  # pragma: no cover
    _GYM = False

    class gym:  # type: ignore
        class Env:
            pass

from .provider import LinnaeusRLProblemProvider
from .rewards import SimpleAbstentionReward
from .verifier import TaxonomicRLVerifier


def _float32_image(image):
    if isinstance(image, torch.Tensor):
        return image.float()
    return np.asarray(image, np.float32)


class TaxonomicClassificationEnv(gym.Env):
    metadata = {"render_modes": [], "render_fps": 4}

    def __init__(
        self,
        dataloader=None,
        taxonomy_tree=None,
        problem_provider: LinnaeusRLProblemProvider | None = None,
        verifier: TaxonomicRLVerifier | None = None,
        mode: str = "sequential",
        image_shape: tuple[int, int, int] = (224, 224, 3),
    ):
        super().__init__()
        if taxonomy_tree is None:
            raise ValueError("taxonomy_tree is required")
        self.taxonomy_tree = taxonomy_tree
        self.mode = mode.lower()
        if self.mode not in ("sequential", "multitask"):
            raise ValueError("Mode must be 'sequential' or 'multitask'")
        self.rank_order = list(taxonomy_tree.task_keys)
        self.num_classes_at_rank = dict(taxonomy_tree.num_classes)
        self.max_ranks = len(self.rank_order)
        self.image_shape = tuple(image_shape)

        self.provider = problem_provider or LinnaeusRLProblemProvider(
            dataloader, taxonomy_tree
        )
        self.verifier = verifier or TaxonomicRLVerifier(
            taxonomy_tree, SimpleAbstentionReward(), self.rank_order
        )

        if _GYM:
            obs = {
                "image": spaces.Box(
                    -np.inf, np.inf, shape=self.image_shape, dtype=np.float32
                )
            }
            if self.mode == "sequential":
                obs["current_rank_index"] = spaces.Discrete(self.max_ranks)
            self.observation_space = spaces.Dict(obs)
            if self.mode == "sequential":
                max_classes = max(self.num_classes_at_rank.values() or [1])
                self.action_space = spaces.Discrete(max_classes + 1)
                self.abstain_action_index = max_classes
            else:
                self.action_space = spaces.MultiDiscrete(
                    np.array(
                        [self.num_classes_at_rank.get(r, 0) + 1 for r in self.rank_order]
                    )
                )
        else:
            max_classes = max(self.num_classes_at_rank.values() or [1])
            self.abstain_action_index = max_classes

        self.current_observation: dict[str, Any] | None = None
        self.current_ground_truth: dict[str, int | None] | None = None
        self.current_rank_idx = 0
        self.episode_predictions: list[int | None] = []

    # -------------------------------------------------------------- gym API
    def reset(self, seed: int | None = None, options: dict | None = None):
        if _GYM:
            super().reset(seed=seed)
        obs, gt = self.provider.reset()
        self.current_ground_truth = gt
        self.current_rank_idx = 0
        self.episode_predictions = [None] * self.max_ranks
        image = _float32_image(obs["image"])
        self.current_observation = {"image": image}
        if self.mode == "sequential":
            self.current_observation["current_rank_index"] = 0
        info = {"ground_truth": gt, "aux": obs.get("aux")}
        return self.current_observation, info

    def step(self, action):
        if self.current_observation is None or self.current_ground_truth is None:
            raise RuntimeError("Environment not reset. Call reset() before step().")
        info: dict[str, Any] = {}
        if self.mode == "sequential":
            action = int(action)
            rank = self.rank_order[self.current_rank_idx]
            n_cls = self.num_classes_at_rank.get(rank, 0)
            if action == self.abstain_action_index or action >= n_cls:
                pred = None
            else:
                pred = action
            self.episode_predictions[self.current_rank_idx] = pred
            info["current_rank_idx_processed"] = self.current_rank_idx
            info["action_taken_at_rank"] = action
            self.current_rank_idx += 1
            done = self.current_rank_idx >= self.max_ranks
            reward = 0.0
            if done:
                preds = dict(zip(self.rank_order, self.episode_predictions))
                reward, diags = self.verifier.verify(preds, self.current_ground_truth)
                info["final_predictions"] = preds
                info["diagnostics"] = diags
                info["reason_for_done"] = "all_ranks_processed"
            else:
                self.current_observation = dict(self.current_observation)
                self.current_observation["current_rank_index"] = self.current_rank_idx
            return self.current_observation, reward, done, False, info

        # multitask: one step decides every rank
        action = np.asarray(action)
        preds: dict[str, int | None] = {}
        for i, rank in enumerate(self.rank_order):
            a = int(action[i])
            n_cls = self.num_classes_at_rank.get(rank, 0)
            preds[rank] = None if a >= n_cls else a
        reward, diags = self.verifier.verify(preds, self.current_ground_truth)
        info["final_predictions"] = preds
        info["diagnostics"] = diags
        info["reason_for_done"] = "multitask_single_step"
        return self.current_observation, reward, True, False, info

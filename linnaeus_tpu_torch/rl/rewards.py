"""Abstention reward functions.

Reference parity: rl_env/reward_functions.py:47-230 — SimpleAbstentionReward
(per-rank dense rewards for classify/abstain outcomes) and
EpisodeOutcomeReward (sparse optimal-episode reward).

Predictions/ground truth: ``{task_key: predicted_class_or_None}`` where None
means abstain (ground-truth None = the rank is null/unknown).

Copy of linnaeus_tpu/rl/rewards.py (pure Python).
"""

from __future__ import annotations


class AbstentionRewardFunction:
    def compute_reward(
        self,
        predictions: dict[str, int | None],
        ground_truth: dict[str, int | None],
        confidences: dict | None = None,
        taxonomy_tree=None,
    ) -> float:
        raise NotImplementedError


class SimpleAbstentionReward(AbstentionRewardFunction):
    def __init__(
        self,
        reward_correct_classification: float = 1.0,
        reward_correct_abstention: float = 0.5,
        penalty_misclassification: float = -1.0,
        penalty_unnecessary_abstention: float = -0.5,
        penalty_incorrect_prediction_at_null_rank: float = -1.0,
    ):
        self.reward_correct_classification = reward_correct_classification
        self.reward_correct_abstention = reward_correct_abstention
        self.penalty_misclassification = penalty_misclassification
        self.penalty_unnecessary_abstention = penalty_unnecessary_abstention
        self.penalty_incorrect_prediction_at_null_rank = (
            penalty_incorrect_prediction_at_null_rank
        )

    def compute_reward(self, predictions, ground_truth, confidences=None,
                       taxonomy_tree=None) -> float:
        total = 0.0
        for task, true in ground_truth.items():
            pred = predictions.get(task)
            if true is None:  # rank unknown -> abstention is correct
                if pred is None:
                    total += self.reward_correct_abstention
                else:
                    total += self.penalty_incorrect_prediction_at_null_rank
            else:
                if pred is None:
                    total += self.penalty_unnecessary_abstention
                elif pred == true:
                    total += self.reward_correct_classification
                else:
                    total += self.penalty_misclassification
        return total


class EpisodeOutcomeReward(AbstentionRewardFunction):
    def __init__(
        self,
        reward_optimal_outcome: float = 1.0,
        penalty_suboptimal_outcome: float = -1.0,
    ):
        self.reward_optimal_outcome = reward_optimal_outcome
        self.penalty_suboptimal_outcome = penalty_suboptimal_outcome

    def compute_reward(self, predictions, ground_truth, confidences=None,
                       taxonomy_tree=None) -> float:
        for task, true in ground_truth.items():
            pred = predictions.get(task)
            if true is None:
                if pred is not None:
                    return self.penalty_suboptimal_outcome
            else:
                if pred != true:
                    return self.penalty_suboptimal_outcome
        return self.reward_optimal_outcome

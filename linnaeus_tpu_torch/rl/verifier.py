"""Taxonomic RL verifier (reference parity: rl_env/verifier.py:8-120).

Scores an episode's predictions against ground truth via a reward function
and reports per-rank correctness diagnostics.

Copy of linnaeus_tpu/rl/verifier.py (pure Python).
"""

from __future__ import annotations

from .rewards import AbstentionRewardFunction, SimpleAbstentionReward


class TaxonomicRLVerifier:
    def __init__(
        self,
        taxonomy_tree,
        reward_function: AbstentionRewardFunction | None = None,
        rank_order: list[str] | None = None,
    ):
        self.taxonomy_tree = taxonomy_tree
        self.reward_function = reward_function or SimpleAbstentionReward()
        self.rank_order = rank_order or list(taxonomy_tree.task_keys)

    def verify(
        self,
        predictions: dict[str, int | None],
        ground_truth: dict[str, int | None],
        confidences: dict | None = None,
    ) -> tuple[float, dict]:
        reward = self.reward_function.compute_reward(
            predictions, ground_truth, confidences, self.taxonomy_tree
        )
        diagnostics = {}
        for task in self.rank_order:
            true = ground_truth.get(task)
            pred = predictions.get(task)
            if true is None:
                outcome = "correct_abstention" if pred is None else "false_prediction"
            elif pred is None:
                outcome = "unnecessary_abstention"
            elif pred == true:
                outcome = "correct"
            else:
                outcome = "misclassification"
            diagnostics[task] = outcome
        return reward, diagnostics

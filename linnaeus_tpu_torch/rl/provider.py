"""RL problem provider wrapping a data loader.

Port of linnaeus_tpu/rl/provider.py (reference parity:
rl_env/problem_provider.py:9-290): iterates the loader, serving one sample
at a time and converting supervised null labels (class index 0) into
``None`` abstention targets.

The port's loader hands over device tensors (data/loader.py), so a batch's
images stay on the device and are normalised there, float32 divided by 255
as ``normalize_host_images`` does on the host; only the targets go to the
host, once a batch. A copy of every sample back to the host would set the
rollout's pace.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch


def normalize_host_images(arr: np.ndarray) -> np.ndarray:
    """uint8 host pipeline -> [0,1] float32 (copied from the JAX package)."""
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.float32) / 255.0
    return arr


def normalize_images(images) -> torch.Tensor:
    """``normalize_host_images`` where the images lie: an integer tensor
    (or array) becomes float32 divided by 255 on its device; a floating
    tensor is returned as it is."""
    images = torch.as_tensor(images)
    if not images.dtype.is_floating_point:
        return images.float() / 255.0
    return images


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return np.asarray(values)


class LinnaeusRLProblemProvider:
    def __init__(self, dataloader, taxonomy_tree, null_index: int = 0):
        self.dataloader = dataloader
        self.taxonomy_tree = taxonomy_tree
        self.task_keys = list(taxonomy_tree.task_keys)
        self.null_index = null_index
        self._batch_iter: Iterator | None = None
        self._batch: dict | None = None
        self._pos = 0

    def _load(self, batch: dict) -> dict:
        """One batch as the provider serves it: images normalised on their
        device, the targets on the host."""
        return {
            "images": normalize_images(batch["images"]),
            "aux": batch.get("aux"),
            "targets": {t: _host(v) for t, v in batch["targets"].items()},
        }

    def _next_sample(self) -> dict[str, Any]:
        while True:
            if self._batch is None or self._pos >= len(self._batch["images"]):
                if self._batch_iter is None:
                    self._batch_iter = iter(self.dataloader)
                try:
                    batch = next(self._batch_iter)
                except StopIteration:
                    self._batch_iter = iter(self.dataloader)
                    batch = next(self._batch_iter)
                self._batch = self._load(batch)
                self._pos = 0
            i = self._pos
            self._pos += 1
            return {
                "image": self._batch["images"][i],
                "aux": self._batch["aux"][i] if self._batch.get("aux") is not None else None,
                "targets": {
                    t: int(np.asarray(v[i]).argmax()) if np.ndim(v[i]) > 0 else int(v[i])
                    for t, v in self._batch["targets"].items()
                },
            }

    def reset(self) -> tuple[dict[str, Any], dict[str, int | None]]:
        """Returns (observation, ground_truth) for a fresh sample.

        Null supervised labels (index 0) become None abstention targets.
        """
        sample = self._next_sample()
        gt = {
            t: (None if idx == self.null_index else idx)
            for t, idx in sample["targets"].items()
        }
        obs = {"image": sample["image"], "aux": sample["aux"]}
        return obs, gt

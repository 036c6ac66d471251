"""Per-sample loss primitives.

Port of linnaeus_tpu/loss/basic.py. Every function returns a per-sample
vector of shape [B] and accepts either hard integer labels [B] or soft /
one-hot targets [B, C]. Logits are promoted to float32 for the log-softmax,
so the loss numerics stay float32 under a bfloat16 compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(logits.float(), dim=-1)


def _as_soft(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    if target.dim() == 1:
        return one_hot(target, num_classes)
    return target.float()


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside [0, num_classes) (the unmapped
    -1) gives an all-zero row, which carries no loss mass."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes[None, :]).float()


def cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain CE; soft targets are handled like SoftTargetCrossEntropy."""
    log_probs = _log_softmax(logits)
    soft = _as_soft(target, logits.shape[-1])
    loss = -(soft * log_probs).sum(dim=-1)
    if class_weights is not None:
        loss = loss * (soft * class_weights[None, :].float()).sum(dim=-1)
    return loss


def label_smoothing_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    smoothing: float = 0.1,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """NLL with uniform label smoothing. Soft targets are argmax-hardened
    first. All-zero target rows (unmapped labels) carry zero loss: argmax
    would otherwise harden them to class 0 and train the model toward null
    on unlabelled samples."""
    mass = None
    if target.dim() == 2:
        mass = target.sum(dim=-1)
        target = target.argmax(dim=-1)
    log_probs = _log_softmax(logits)
    nll = -log_probs.gather(-1, target[:, None])[:, 0]
    smooth = -log_probs.mean(dim=-1)
    loss = (1.0 - smoothing) * nll + smoothing * smooth
    if class_weights is not None:
        loss = loss * class_weights[target].float()
    if mass is not None:
        loss = loss * (mass > 0).to(loss.dtype)
    return loss


def soft_target_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    class_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """CE against a soft distribution (mixup targets)."""
    return cross_entropy(logits, target, class_weights)


def taxonomy_smoothed_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    smoothing_matrix: torch.Tensor,
) -> torch.Tensor:
    """CE against taxonomy-distance-smoothed label rows. ``smoothing_matrix``
    is [C, C]; row i is the smoothed distribution for true class i. Soft
    targets mix rows by their probabilities."""
    log_probs = _log_softmax(logits)
    soft = _as_soft(target, logits.shape[-1])
    smoothed = soft @ smoothing_matrix.float()
    return -(smoothed * log_probs).sum(dim=-1)

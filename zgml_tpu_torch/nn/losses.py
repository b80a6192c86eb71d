"""Losses; counterpart of zgml_tpu/nn/losses.py, the same formulas in f32."""
from __future__ import annotations

import torch


def mean_sq_err(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.to(torch.float32) - target.to(torch.float32)
    return torch.mean(d * d)


def cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.sum(target_probs * logp, dim=-1))


def cross_entropy_idx(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Integer-target cross entropy, mean(-log_softmax(logits)[target])."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, targets.to(torch.int64)[..., None])[..., 0]
    return -torch.mean(picked)

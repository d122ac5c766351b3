"""Logit-space OOD scores (``tpuhar/ood.py``); higher = more likely OOD."""
from __future__ import annotations

import torch


def msp_score(logits: torch.Tensor) -> torch.Tensor:
    """Maximum-softmax-probability score: ``1 - max_c p(c|x)``."""
    return 1.0 - torch.softmax(logits.float(), dim=-1).max(dim=-1).values


def energy_score(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Energy score: ``-T · logsumexp(logits / T)``."""
    t = float(temperature)
    return -t * torch.logsumexp(logits.float() / t, dim=-1)

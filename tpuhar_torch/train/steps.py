"""Train and eval steps of cross-modal pretraining (``tpuhar/train/steps.py``).

``make_crossmodal_steps(config)`` returns ``train_step(state, batch, generator)`` and
``eval_step(state, batch)``. A batch is ``{"imu": (B, C, T) f32 featurized windows,
"video": (B, T, H, W, 3) uint8}`` (plus ``"n_valid"`` for a zero-padded evaluation
batch), on the model's device; the clip is normalized inside the step. The model keeps
f32 master weights and computes through ``CrossModalModel.forward_cast``; the loss is
SigLIP with the model's live scalars or InfoNCE at the configured temperature. Each
step runs inside ``precision_scope(training.pretrain_matmul_precision)``, which sets
PyTorch's f32 matmul and cuDNN precision for the step and restores them after.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from .. import losses as L
from ..ops.video import normalize_clip
from .optim import PretrainOptimizer

# pretrain_matmul_precision (JAX's default_matmul_precision names) -> torch's f32 matmul
# precision; "highest" also turns cuDNN's TF32 off
_PRECISIONS = {
    "float32": "highest", "highest": "highest",
    "tensorfloat32": "high", "high": "high",
    "bfloat16": "medium", "fastest": "medium",
}


@contextlib.contextmanager
def precision_scope(precision: str):
    """f32 matmuls (and cuDNN convolutions) at ``precision`` inside the scope: "float32"
    is full f32 (TF32 off); "" or "default" leaves PyTorch's settings alone."""
    if precision in ("", "default"):
        yield
        return
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision(_PRECISIONS[precision])
    torch.backends.cudnn.allow_tf32 = _PRECISIONS[precision] != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


@dataclass
class TrainState:
    """The model (f32 master weights; BatchNorm running stats are its buffers), its
    optimizer (which holds the learning-rate schedule, as optax's chain does, and its
    step count) and the number of steps taken."""

    model: torch.nn.Module
    optimizer: PretrainOptimizer
    step: int = 0


def contrastive_loss_fn(config) -> Callable:
    """``loss(out, n_valid=None)`` of the model's output dict, as ``use_sigmoid_loss``
    and ``replicate_siglip_sign_quirk`` select it."""
    t = config.training
    quirk, temperature = bool(t.replicate_siglip_sign_quirk), float(t.temperature)

    def contrastive_loss(out, n_valid=None):
        if bool(t.use_sigmoid_loss):
            return L.siglip_loss(
                out["imu_proj"], out["video_proj"], out["logit_scale"], out["logit_bias"],
                quirk_sign_flip=quirk, n_valid=n_valid,
            )
        return L.infonce_loss(out["imu_proj"], out["video_proj"], temperature, n_valid=n_valid)

    return contrastive_loss


def make_crossmodal_steps(config) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` of contrastive pretraining."""
    if bool(config.data.use_augmentation):
        raise NotImplementedError("IMU augmentation (ops/augment.py) is not ported")
    contrastive_loss = contrastive_loss_fn(config)
    precision = str(getattr(config.training, "pretrain_matmul_precision", "float32"))

    def train_step(state: TrainState, batch: Dict, generator=None) -> Tuple[TrainState, Dict]:
        """One update in place: the loss on the batch (dropout from ``generator``, a
        ``torch.Generator`` on the model's device; BatchNorm in train mode), its
        gradients, then the optimizer. Returns the state and ``{"loss"}`` (a 0-d tensor
        on the device: nothing waits for the device)."""
        with precision_scope(precision):
            out = state.model.forward_cast(
                batch["imu"], normalize_clip(batch["video"]), train=True, generator=generator
            )
            loss = contrastive_loss(out)
            for p in state.optimizer.params:
                p.grad = None
            loss.backward()
            state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    def eval_step(state: TrainState, batch: Dict) -> Dict:
        """The loss at eval (running BatchNorm stats, no dropout), over the first
        ``n_valid`` rows where the batch is zero-padded."""
        n_valid = batch.get("n_valid")
        with precision_scope(precision), torch.no_grad():
            out = state.model.forward_cast(batch["imu"], normalize_clip(batch["video"]), train=False)
            loss = contrastive_loss(out, n_valid=n_valid)
        return {"loss": loss, "n_valid": batch["imu"].shape[0] if n_valid is None else n_valid}

    return train_step, eval_step

"""Train and eval steps of cross-modal pretraining and of the classifiers
(``tpuhar/train/steps.py``).

``make_crossmodal_steps(config)`` returns ``train_step(state, batch, generator)`` and
``eval_step(state, batch)``. A batch is ``{"imu": (B, C, T) f32 featurized windows,
"video": (B, T, H, W, 3) uint8}`` (plus ``"n_valid"`` for a zero-padded evaluation
batch), on the model's device; the clip is normalized inside the step. The model keeps
f32 master weights and computes through ``forward_cast``; the loss is SigLIP with the
model's live scalars or InfoNCE at the configured temperature.

``make_classification_steps`` (the IMU classifier), ``make_video_steps`` and
``make_fusion_steps`` return ``train_step(state, batch, generator)``, which takes
``"label"`` (B,) int labels besides the inputs and returns the cross-entropy ``loss`` and
the batch's ``accuracy`` (%), and ``predict_step(state, batch)``, which returns the
``logits``, ``embeddings``, ``preds``, the cross-entropy summed over the first
``n_valid`` rows (``loss_sum``) and the ``valid`` mask.

With ``data.use_augmentation`` the IMU windows of a train step go through
``ops/augment.augment_imu`` first, its draws taken from the step's generator before
dropout's. Each step runs inside ``precision_scope(training.pretrain_matmul_precision)``,
which sets PyTorch's f32 matmul and cuDNN precision for the step and restores them
after.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from .. import losses as L
from ..ops.augment import augment_imu
from ..ops.video import normalize_clip
from .optim import AdamW

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
    optimizer: AdamW
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


def _precision(config) -> str:
    return str(getattr(config.training, "pretrain_matmul_precision", "float32"))


def _augmented(config, imu: torch.Tensor, generator) -> torch.Tensor:
    """The train step's IMU windows: augmented when ``data.use_augmentation`` is set."""
    return augment_imu(imu, config, generator) if bool(config.data.use_augmentation) else imu


def _update(state: TrainState, loss: torch.Tensor) -> None:
    """The loss's gradients, then one optimizer step, in place."""
    for p in state.optimizer.params:
        p.grad = None
    loss.backward()
    state.optimizer.step()
    state.step += 1


def make_crossmodal_steps(config) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` of contrastive pretraining."""
    contrastive_loss = contrastive_loss_fn(config)
    precision = _precision(config)

    def train_step(state: TrainState, batch: Dict, generator=None) -> Tuple[TrainState, Dict]:
        """One update in place: the loss on the batch (dropout from ``generator``, a
        ``torch.Generator`` on the model's device; BatchNorm in train mode), its
        gradients, then the optimizer. Returns the state and ``{"loss"}`` (a 0-d tensor
        on the device: nothing waits for the device)."""
        with precision_scope(precision):
            imu = _augmented(config, batch["imu"], generator)
            out = state.model.forward_cast(imu, normalize_clip(batch["video"]), train=True, generator=generator)
            loss = contrastive_loss(out)
            _update(state, loss)
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


def _classifier_steps(config, inputs: Callable[[Dict, bool, object], tuple]) -> Tuple[Callable, Callable]:
    """``(train_step, predict_step)`` of a classifier whose model takes ``inputs(batch,
    train, generator)``."""
    precision = _precision(config)

    def train_step(state: TrainState, batch: Dict, generator=None) -> Tuple[TrainState, Dict]:
        """One update in place: the cross-entropy on the batch's ``"label"`` (dropout and
        augmentation from ``generator``, a ``torch.Generator`` on the model's device;
        BatchNorm in train mode), its gradients, then the optimizer. Returns the state
        and ``{"loss", "accuracy"}``, 0-d tensors on the device."""
        with precision_scope(precision):
            logits, _ = state.model.forward_cast(*inputs(batch, True, generator), train=True, generator=generator)
            loss = L.cross_entropy_loss(logits, batch["label"])
            _update(state, loss)
        hits = (torch.argmax(logits.detach(), dim=-1) == batch["label"]).float()
        return state, {"loss": loss.detach(), "accuracy": hits.mean() * 100.0}

    def predict_step(state: TrainState, batch: Dict) -> Dict:
        """The eval forward (running BatchNorm statistics, no dropout) on a batch whose
        rows past ``n_valid`` are padding; without ``"label"`` the loss is that of
        class 0."""
        with precision_scope(precision), torch.no_grad():
            logits, emb = state.model.forward_cast(*inputs(batch, False, None), train=False)
            B = logits.shape[0]
            labels = batch.get("label")
            if labels is None:
                labels = torch.zeros(B, dtype=torch.long, device=logits.device)
            loss_per = L.cross_entropy_rows(logits, labels)
            valid = torch.arange(B, device=logits.device) < torch.as_tensor(batch.get("n_valid", B), device=logits.device)
            return {
                "logits": logits,
                "embeddings": emb,
                "preds": torch.argmax(logits, dim=-1),
                "loss_sum": (loss_per * valid).sum(),
                "valid": valid,
            }

    return train_step, predict_step


def classification_step_fns(config) -> Tuple[Callable, Callable]:
    """``(train_step, predict_step)`` of the IMU classifier: batches ``{"imu": (B, C, T)
    featurized f32, "label"}``."""

    def inputs(batch, train, generator):
        return (_augmented(config, batch["imu"], generator) if train else batch["imu"],)

    return _classifier_steps(config, inputs)


# the JAX package jits classification_step_fns' steps under this name; here both are one
make_classification_steps = classification_step_fns


def make_video_steps(config) -> Tuple[Callable, Callable]:
    """``(train_step, predict_step)`` of the video-only classifier: batches ``{"video":
    (B, T, H, W, 3) uint8, "label"}``, the clip normalized inside the step."""
    return _classifier_steps(config, lambda batch, train, generator: (normalize_clip(batch["video"]),))


def make_fusion_steps(config) -> Tuple[Callable, Callable]:
    """``(train_step, predict_step)`` of the fusion classifier: batches ``{"imu", "video",
    "label"}``."""

    def inputs(batch, train, generator):
        imu = _augmented(config, batch["imu"], generator) if train else batch["imu"]
        return imu, normalize_clip(batch["video"])

    return _classifier_steps(config, inputs)

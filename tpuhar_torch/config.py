"""Central configuration of the port: its own copy of ``tpuhar/config.py``.

The port imports nothing of the JAX package, so it keeps this stdlib-only copy. The
sections, field names and defaults equal the JAX package's, field by field
(``tests/test_torch_config.py`` pins them), and a config saved by one package loads
in the other. The text below is the JAX package's.

Mirrors the reference config tree (``configs/config.py:9-185``) field-for-field so that a
user of the reference can switch without relearning knobs, with three deliberate upgrades:

1. "Ghost" keys the reference reads via ``getattr(cfg, key, default)`` but never declares
   (SURVEY.md quirk Q6) are explicit dataclass fields here with the reference's effective
   defaults: ``Racc``/``Rgyro`` (``preprocessing.py:178-179``), ``pad_short_sequences``
   (``preprocessing.py:232``), ``require_video`` (``preprocessing.py:266``),
   ``imu_original_rate`` (``preprocessing.py:269``), ``video_channel_first``
   (``datasets.py:73``, ``trainer.py:108``).
2. ``Config.load()`` actually reconstructs from JSON (the reference's is a stub that
   returns a default instance, ``configs/config.py:174-181``).
3. North-star extensions the reference repo names but never implements (OOD scoring,
   STFT featurization, 1D-CNN IMU encoder, cross-attention fusion) get their own
   dataclasses, plus quirk-replication flags for bit-parity runs against the reference.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import List, Optional, Tuple


def _default_base_input() -> Path:
    if os.path.exists("/kaggle"):
        return Path("/kaggle/input/dataset-har/UESTC-MMEA-CL")
    return Path("./data/UESTC-MMEA-CL")


def _default_base_output() -> Path:
    if os.path.exists("/kaggle"):
        return Path("/kaggle/working")
    return Path("./outputs")


@dataclass
class PathConfig:
    """Dataset/output path layout (reference ``configs/config.py:10-46``).

    Directory creation is deferred to :meth:`ensure_dirs` instead of ``__post_init__``
    so constructing a config never touches the filesystem (important for tests and for
    pure-function pipelines); the CLI calls ``ensure_dirs()`` once at startup.
    """

    is_kaggle: bool = field(default_factory=lambda: os.path.exists("/kaggle"))
    base_input: Path = field(default_factory=_default_base_input)
    base_output: Path = field(default_factory=_default_base_output)

    train_file: str = "train.txt"
    val_file: str = "val.txt"
    test_file: str = "test.txt"

    sensor_dir: str = "sensor"
    video_dir: str = "video"

    def __post_init__(self) -> None:
        self.base_input = Path(self.base_input)
        self.base_output = Path(self.base_output)
        self.preprocessed_dir = self.base_output / "preprocessed"
        self.checkpoints_dir = self.base_output / "checkpoints"
        self.logs_dir = self.base_output / "logs"
        self.results_dir = self.base_output / "results"

    def ensure_dirs(self) -> None:
        for d in (
            self.base_output,
            self.preprocessed_dir,
            self.checkpoints_dir,
            self.logs_dir,
            self.results_dir,
        ):
            Path(d).mkdir(parents=True, exist_ok=True)


@dataclass
class DataConfig:
    """Preprocessing / data knobs (reference ``configs/config.py:50-70`` + ghost keys)."""

    # IMU
    imu_window_size: int = 250  # 5 seconds at 50 Hz
    imu_stride: int = 125  # 50% overlap
    imu_sampling_rate: int = 50  # Hz
    imu_channels: int = 6  # 3 acc + 3 gyro

    # Video
    video_fps: int = 25
    video_frames_per_window: int = 16
    video_resize: Tuple[int, int] = (224, 224)

    # Normalization
    normalize_imu: bool = True
    median_filter_kernel: int = 5
    # Where z-score statistics come from: "sequence" (reference behavior,
    # preprocessing.py:215-219 — stats over the whole recording) or "window"
    # (stats per window, EXACTLY matching the serving engine, which only ever sees
    # one window; use this when training models that will be served through
    # InferenceEngine so train and serve distributions agree).
    zscore_scope: str = "sequence"

    # Augmentation (optional)
    use_augmentation: bool = False
    jitter_strength: float = 0.1
    time_warp_strength: float = 0.2

    # --- ghost keys made explicit (quirk Q6), reference effective defaults ---
    Racc: float = 16384.0  # raw accel LSB per g   (preprocessing.py:178)
    Rgyro: float = 16.4  # raw gyro LSB per deg/s  (preprocessing.py:179)
    pad_short_sequences: bool = True  # zero-pad sequences < window (preprocessing.py:232)
    require_video: bool = False  # skip samples without video (preprocessing.py:266)
    imu_original_rate: Optional[int] = None  # resample source rate (preprocessing.py:269)
    video_channel_first: bool = False  # clip layout (C,T,H,W) vs (T,C,H,W) (datasets.py:73)

    # --- TPU-native additions ---
    # Where normalization/windowing executes: "device" runs the fused jnp/Pallas path,
    # "host" reproduces the reference's scipy path (useful for golden tests).
    featurize_backend: str = "device"
    # Cap for on-device variable-length sequence processing (sequences are padded+masked
    # to the next bucket <= this; keeps XLA shapes static).
    max_sequence_length: int = 16384
    # Video-decode worker processes for the loader (0 = in-process thread pool).
    # The process pool scales clip decode with host cores (torch DataLoader
    # num_workers equivalent); threads suffice on small hosts.
    decode_processes: int = 0
    # Threads per native batched-JPEG clip decode (tpuhar/native; GIL-released
    # libjpeg-turbo fan-out inside one read_clip call). 1 is right for this
    # 1-core container; raise on multi-core serving hosts.
    decode_threads: int = 1
    # Input-pipeline backend: "default" (BatchLoader) or "grain" (Google Grain
    # MapDataset with multiprocess prefetch — production multi-core hosts).
    loader_backend: str = "default"
    # Grain worker processes (0 = in-process map; only used when loader_backend="grain").
    grain_workers: int = 0
    # IMU featurizer fed to the encoder: "raw" (reference behavior) or "stft"
    # (north-star spectrogram path).
    imu_featurizer: str = "raw"
    # STFT parameters (used when imu_featurizer == "stft")
    stft_nperseg: int = 64
    stft_hop: int = 32
    # Offline frame extraction: preprocessing decodes each video once and caches the
    # selected frames as JPEGs ({split}_frames.bin); training then avoids per-epoch
    # mp4 seek-decoding entirely (the reference seeks 16x per clip per epoch).
    extract_frames: bool = True
    frame_jpeg_quality: int = 90


@dataclass
class ModelConfig:
    """Model knobs (reference ``configs/config.py:74-96`` + north-star additions)."""

    # IMU Encoder (PatchTST-like)
    imu_patch_size: int = 16
    imu_stride: int = 16
    imu_d_model: int = 128
    imu_nhead: int = 8
    imu_num_layers: int = 4
    imu_dropout: float = 0.1

    # Video Encoder
    video_backbone: str = "videomae_base"  # "videomae_*" ViT | "resnet18" | "mobilenet_v2"
    video_pretrained: bool = True
    # Local torch checkpoint to graft into the video backbone when
    # ``video_pretrained`` is True (HF ``pytorch_model.bin`` / torchvision ``.pth`` /
    # numpy ``.npz``). The reference downloads weights at construction time
    # (``models.py:157``, ``:164-170``); this build is network-isolated, so the
    # equivalent is conversion from a file already on disk (``models/convert.py``).
    video_weights_path: Optional[str] = None
    # HF VideoMAE checkpoints trained with use_mean_pooling=True ship NO final
    # LayerNorm; set False to match such checkpoints when grafting.
    video_use_final_norm: bool = True
    video_d_model: int = 768
    # ViT MLP GELU variant. False = exact erf GELU (HF VideoMAE parity —
    # models/convert.py golden tests depend on it). True = tanh approximation:
    # measured 1.15 vs 2.97 ms per block-MLP at the serving shape (~17% of the
    # videomae_small step, scripts/perf_vit_stages2.py) with rel-RMS output
    # drift 2.5e-3 ≈ bf16 rounding. The serving engine enables it for ViT
    # backbones by default (InferenceEngine(fast_gelu=...)); training/eval
    # default stays exact.
    gelu_approximate: bool = False

    # Projection heads
    projection_dim: int = 256
    projection_hidden_dim: int = 512

    # Classifier
    num_classes: int = 32  # UESTC-MMEA-CL has 32 classes
    classifier_hidden_dims: List[int] = field(default_factory=lambda: [256, 128])
    classifier_dropout: float = 0.3

    # --- TPU-native additions ---
    # IMU encoder family: "transformer" (PatchTST-like, reference) or "cnn" (north-star
    # 1D-CNN variant).
    imu_encoder: str = "transformer"
    imu_cnn_channels: List[int] = field(default_factory=lambda: [64, 128, 128])
    imu_cnn_kernel: int = 9

    # Cross-attention fusion classifier (north-star): number of fusion layers/heads.
    fusion_layers: int = 2
    fusion_heads: int = 8

    # Norm used in projection/classifier heads. The reference uses BatchNorm1d
    # (models.py:228, :318); "batch" reproduces that (with cross-replica stats under
    # pjit), "layer" swaps to LayerNorm which is friendlier to jit/vmap.
    head_norm: str = "batch"

    # Compute dtype for encoders ("bfloat16" uses the MXU's native precision; params
    # stay float32).
    compute_dtype: str = "bfloat16"

    # Rematerialize video-ViT blocks in backward (jax.checkpoint) — trades FLOPs for
    # activation memory when pretraining with large batches.
    remat_video: bool = False

    # Pallas flash attention in the video ViT (TPU only; falls back to XLA attention
    # elsewhere). Block sizes must be 128-multiples; at N=1568 smaller blocks pad
    # less (512->2048 tokens, 256->1792, 128->1664) — sweep scripts/perf_flash.py.
    use_flash_attention: bool = False
    flash_block_q: int = 512
    flash_block_k: int = 512
    # "lean": purpose-built forward-only kernel (ops/flash_lean.py — Q tiles
    # divide N=1568 exactly, KV pads +14%); "library": stock Pallas kernel.
    flash_kernel: str = "lean"

    # Serving conv backend for the TPUVideoCNN residual stages: "xla" or "pallas"
    # (ops/conv3x3.py fused conv+BN+ReLU+residual kernel; eval-mode only — training
    # always uses XLA convs with live batch stats).
    conv_backend: str = "xla"

    # --- quirk-replication flags (SURVEY.md §2.1) ---
    # Q1: reference truncates the IMU token stream from 1+C*N=91 tokens to
    # max_patches+1=16, so the transformer only ever sees channel 0. Default False sizes
    # the positional table C*N+1 and keeps every channel.
    replicate_pos_truncation: bool = False
    # Keep the reference's dead `temperature`/`bias` params on CrossModalModel
    # (models.py:267-268) for checkpoint-shape parity.
    keep_dead_params: bool = True


@dataclass
class TrainingConfig:
    """Training knobs (reference ``configs/config.py:100-131``)."""

    # General
    seed: int = 42
    device: str = "tpu"  # informational; JAX picks the platform
    num_workers: int = 2

    # Cross-modal pretraining
    pretrain_epochs: int = 10
    pretrain_batch_size: int = 16
    pretrain_lr: float = 1e-4
    pretrain_weight_decay: float = 0.01
    pretrain_warmup_epochs: int = 5
    # Matmul precision for the pretraining stage's f32 operands ("float32" |
    # "tensorfloat32" | "default").  TPU's default bf16 matmul precision can
    # silently stall contrastive pretraining — the InfoNCE similarity gradients
    # round away and the loss pins at ln(batch) (measured: 15 chip epochs flat
    # at ln 64 on data CPU-f32 solves by epoch 2; scripts/article_workflow.py).
    # Only affects f32 operands; compute_dtype="bfloat16" towers are untouched.
    pretrain_matmul_precision: str = "float32"

    # Contrastive loss
    temperature: float = 0.07
    use_sigmoid_loss: bool = True
    # Train the SigLIP log-temperature/bias scalars. The reference's are effectively
    # frozen (quirk Q11: its loss-module params never reach the optimizer). At small
    # batch/dataset sizes a learnable bias admits a collapse (everything classified
    # negative, bias→-inf); freezing restores the alignment gradient.
    train_loss_scalars: bool = True

    # Classification
    train_epochs: int = 100
    train_batch_size: int = 64
    train_lr_encoder: float = 1e-6  # finetuning
    train_lr_head: float = 1e-3  # classification head

    # Early stopping
    patience: int = 15
    min_delta: float = 0.001

    # Checkpointing
    save_every: int = 5
    save_best_only: bool = True

    # --- TPU-native additions ---
    grad_clip_norm: float = 1.0  # reference hardcodes clip_grad_norm_(1.0) (trainer.py:139)
    # Q2: the reference's SigmoidContrastiveLoss flips the sign of the off-diagonal
    # (negative-pair) term vs true SigLIP (losses.py:44-52). Default False implements
    # correct SigLIP; True reproduces the reference formula bit-for-bit.
    replicate_siglip_sign_quirk: bool = False
    # Number of data-parallel shards the input batch is split over (mesh 'data' axis).
    data_axis: str = "data"
    model_axis: str = "model"
    # Pipeline-level parallel training (reference equivalent: DataParallel wrapping
    # when >1 GPU, main.py:89-95). When True and >1 device is visible, the CLI stages
    # train over a dp(×tp) mesh: batches sharded over 'data', params/optimizer moments
    # tensor-parallel over 'model' when model_axis_size > 1.
    data_parallel: bool = True
    model_axis_size: int = 1


@dataclass
class EvalConfig:
    """Evaluation knobs (reference ``configs/config.py:134-146``)."""

    metrics: List[str] = field(
        default_factory=lambda: [
            "accuracy",
            "balanced_accuracy",
            "f1_macro",
            "precision_macro",
            "recall_macro",
        ]
    )

    few_shot_samples: List[int] = field(default_factory=lambda: [10, 20, 50, 100])
    few_shot_runs: int = 5

    eval_modes: List[str] = field(default_factory=lambda: ["linear_probe", "finetune"])

    # Q4: the reference early-stops few-shot runs on the *test* loader
    # (evaluator.py:174,:191). Default False uses the held-out val split; True
    # reproduces the leakage for comparison runs.
    replicate_test_as_val: bool = False
    # Run the few-shot grid's independent runs batched via vmap across a mesh.
    parallel_few_shot: bool = True


@dataclass
class OODConfig:
    """Out-of-distribution scoring (north-star; absent from the reference code)."""

    enabled: bool = True
    # Any of: msp, energy (logit-space); mahalanobis, rmd (relative Mahalanobis),
    # knn (deep nearest-neighbor) (embedding-space, fitted on ID-train embeddings).
    scores: List[str] = field(default_factory=lambda: ["msp", "energy", "mahalanobis"])
    energy_temperature: float = 1.0
    knn_k: int = 10  # k-th neighbor distance for the "knn" score
    # Leave-one-activity-out protocol: each listed class index is held out as OOD in
    # turn; empty list means "every class in turn".
    leave_out_classes: List[int] = field(default_factory=list)
    # "imu" (reference-style IMU classifier) or "fusion" (north-star FusionClassifier
    # on IMU+video windows; AUROC then reflects the video tower's representation).
    model_kind: str = "imu"


class Config:
    """Global configuration tree (reference ``configs/config.py:149-185``)."""

    def __init__(self) -> None:
        self.paths = PathConfig()
        self.data = DataConfig()
        self.model = ModelConfig()
        self.training = TrainingConfig()
        self.eval = EvalConfig()
        self.ood = OODConfig()

    # -- serialization ------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "paths": {k: v for k, v in vars(self.paths).items()},
            "data": vars(self.data),
            "model": vars(self.model),
            "training": vars(self.training),
            "eval": vars(self.eval),
            "ood": vars(self.ood),
        }

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)

    @classmethod
    def load(cls, path) -> "Config":
        """Reconstruct a config from JSON (the reference's load is a stub)."""
        with open(path) as f:
            d = json.load(f)
        cfg = cls()
        for section_name, section in (
            ("paths", cfg.paths),
            ("data", cfg.data),
            ("model", cfg.model),
            ("training", cfg.training),
            ("eval", cfg.eval),
            ("ood", cfg.ood),
        ):
            src = d.get(section_name, {})
            if not is_dataclass(section):
                continue
            declared = {f.name: f for f in fields(section)}
            for key, value in src.items():
                if key not in declared:
                    # derived attrs like preprocessed_dir are recomputed below
                    continue
                cur = getattr(section, key)
                if isinstance(cur, Path):
                    value = Path(value)
                elif isinstance(cur, tuple) and isinstance(value, list):
                    value = tuple(value)
                setattr(section, key, value)
        # recompute derived paths
        cfg.paths.__post_init__()
        return cfg

    def override(self, dotted: str, value) -> None:
        """Apply a CLI override like ``training.pretrain_epochs=3``."""
        section_name, key = dotted.split(".", 1)
        section = getattr(self, section_name)
        cur = getattr(section, key)  # raises AttributeError on unknown keys
        if isinstance(value, str) and value.lower() in ("none", "null"):
            value = None
        elif isinstance(cur, bool):
            value = str(value).lower() in ("1", "true", "yes")
        elif isinstance(cur, Path):
            value = Path(value)
        elif isinstance(cur, (list, tuple)):
            parsed = json.loads(value) if isinstance(value, str) else value
            value = type(cur)(parsed)
        elif cur is not None:
            value = type(cur)(value)
        elif isinstance(value, str):
            # None-default field (e.g. data.imu_original_rate): no current type to
            # copy — parse JSON-style literals so `--set data.imu_original_rate=100`
            # yields an int, not the string "100"; non-literals (paths) stay strings.
            try:
                value = json.loads(value)
            except (ValueError, TypeError):
                pass
        setattr(section, key, value)
        if section_name == "paths":
            self.paths.__post_init__()


# Global instance, mirroring the reference's module singleton (configs/config.py:185).
CONFIG = Config()

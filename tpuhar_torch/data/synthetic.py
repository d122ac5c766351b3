"""A synthetic dataset in the raw UESTC-MMEA-CL layout (``tpuhar/data/synthetic.py``),
copied so that the port imports nothing of the JAX package; the numpy draws come in the
same order, so a seed gives the JAX package's sensor CSVs and split files byte for byte.

``generate_synthetic_dataset`` writes ``train/val/test.txt`` split files,
``sensor/<class_dir>/<prefix>.csv`` headerless N×6 raw-count CSVs and
``video/<class_dir>/<prefix>.mp4`` clips (OpenCV's ``VideoWriter``, ``mp4v``; a writer
that does not open raises), so the whole pipeline runs from raw files: class-dependent
sinusoids plus noise in raw counts, and class-tinted noise video.
``make_synthetic_config`` points the port's ``Config`` at such a dataset with small
sizes.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np


def generate_synthetic_dataset(
    root,
    num_classes: int = 4,
    samples_per_class: int = 3,
    seq_len_range=(300, 700),
    seq_len: Optional[int] = None,
    video_size=(64, 64),
    fps: float = 25.0,
    with_video: bool = True,
    seed: int = 0,
    splits=("train", "val", "test"),
    difficulty: str = "easy",
    label_noise: float = 0.0,
    freq_jitter: Optional[float] = None,
    cross_modal_coupling: bool = False,
    coupling_strength: float = 1.0,
) -> Path:
    """Create a fake dataset under ``root``; returns ``root``.

    Every class appears in every split (different random samples), matching how the
    real split files reference the same class directories.

    ``difficulty``:
      - ``"easy"`` (default, round-1/2 fixture): widely-separated class frequencies
        and amplitudes, strong video tints — every tower saturates (≈100 bal-acc),
        useful for pipeline/CI correctness, useless for comparing towers.
      - ``"hard"``: overlapping class frequencies with per-sequence jitter wider than
        the class gap, amplitude cues removed, 6× the sensor noise, near-identical
        video tints under heavy noise + per-sequence brightness shifts — tuned so
        matched-budget towers land mid-range (VERDICT r2: the accuracy head-to-head
        must be able to *fail*).

    ``label_noise``: fraction of TRAIN-split windows whose label field is flipped to
    a random other class (the files stay in their true class directory — only the
    split-file label lies, as real mislabeled data would).

    ``freq_jitter``: override the hard variant's per-sequence frequency jitter
    half-width in Hz (default ±0.09 vs the 0.12 Hz class gap → Bayes error of a few
    percent, towers land high-90s; ±0.15–0.20 pushes adjacent-class overlap high
    enough for a mid-range landing).  Ignored for ``"easy"``.

    ``cross_modal_coupling``: make the video's brightness pulse at the SEQUENCE's
    drawn IMU frequency instead of a fixed 16-frame period, giving the two
    modalities shared *instance-level* structure.  Without it, within-class
    variation is pure independent noise in both modalities, so a cross-modal
    contrastive loss can only be minimized by pair memorization — measured on
    the hard fixture as train InfoNCE 4.19→1.79 with val 4.14→8.8 (overfit) and
    a collapsed IMU embedding (round 4, `docs/article_hard/`).  Real datasets
    have such instance structure (the same walking bout is visible in both
    sensors); this flag is what makes pretraining *learnable* at fixture scale.
    """
    if difficulty not in ("easy", "hard"):
        raise ValueError(f"difficulty must be 'easy' or 'hard', got {difficulty!r}")
    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / "sensor").mkdir(parents=True, exist_ok=True)
    if with_video:
        (root / "video").mkdir(parents=True, exist_ok=True)

    class_names = [f"{i}_activity{i}" for i in range(num_classes)]

    for split in splits:
        lines: List[str] = []
        for ci, class_dir in enumerate(class_names):
            for si in range(samples_per_class):
                prefix = f"{class_dir}_{split}_{si}"
                n = (
                    int(seq_len)
                    if seq_len is not None
                    else int(rng.integers(seq_len_range[0], seq_len_range[1]))
                )
                raw, seq_freq = _synth_sequence(
                    rng, n, ci, difficulty=difficulty, freq_jitter=freq_jitter
                )
                sdir = root / "sensor" / class_dir
                sdir.mkdir(parents=True, exist_ok=True)
                np.savetxt(sdir / f"{prefix}.csv", raw, delimiter=",", fmt="%.1f")

                if with_video:
                    _write_video(
                        root / "video" / class_dir / f"{prefix}.mp4",
                        rng,
                        ci,
                        num_frames=max(int(n / 50.0 * fps), 8),
                        size=video_size,
                        fps=fps,
                        difficulty=difficulty,
                        pulse_freq=seq_freq if cross_modal_coupling else None,
                        pulse_strength=coupling_strength,
                    )

                label = ci
                if label_noise > 0 and split == "train" and rng.random() < label_noise:
                    label = int((ci + rng.integers(1, num_classes)) % num_classes)
                start, end = 0, max(n // 50, 1)
                lines.append(f"dataset/data/{class_dir}/{prefix} {start} {end} {label}")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root


def _synth_sequence(
    rng: np.random.Generator, n: int, class_idx: int, difficulty: str = "easy",
    freq_jitter: Optional[float] = None,
) -> np.ndarray:
    """Class-dependent 6-channel raw-count IMU sequence (acc ~ ±1g, gyro ~ ±50 deg/s).

    ``hard``: class frequencies 0.12 Hz apart with ±0.09 Hz per-sequence jitter
    (adjacent classes overlap), amplitudes shared across classes (no amplitude cue),
    6× sensor noise — separable in aggregate, not per window.
    """
    t = np.arange(n) / 50.0
    out = np.zeros((n, 6), dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=6)
    if difficulty == "hard":
        j = 0.09 if freq_jitter is None else float(freq_jitter)
        freq = 0.8 + 0.12 * class_idx + rng.uniform(-j, j)
        amp_acc = 16384.0 * 0.4 * rng.uniform(0.85, 1.15)
        amp_gyr = 16.4 * 30.0 * rng.uniform(0.85, 1.15)
        noise = 0.3 * 16384.0
    else:
        freq = 0.5 + 0.7 * class_idx
        amp_acc = 16384.0 * (0.3 + 0.1 * class_idx)
        amp_gyr = 16.4 * (20.0 + 5.0 * class_idx)
        noise = 0.05 * 16384.0
    for c in range(3):
        out[:, c] = amp_acc * np.sin(2 * np.pi * freq * (c + 1) * t + phase[c])
    for c in range(3, 6):
        out[:, c] = amp_gyr * np.sin(2 * np.pi * freq * (c - 2) * t + phase[c])
    out += rng.normal(0, noise, size=out.shape)
    return out.astype(np.float32), float(freq)


def _write_video(
    path: Path, rng, class_idx: int, num_frames: int, size, fps: float,
    difficulty: str = "easy", pulse_freq: Optional[float] = None,
    pulse_strength: float = 1.0,
) -> None:
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    w, h = size
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV's VideoWriter (mp4v) does not open {path}")
    tint = np.zeros(3, dtype=np.float32)
    if difficulty == "hard":
        # weak, overlapping chroma cue buried under noise + a per-sequence global
        # brightness shift (a nuisance factor the model must learn to ignore)
        tint[class_idx % 3] = 18.0 + 6.0 * (class_idx // 3)
        tint[(class_idx + 1) % 3] = 9.0
        base = rng.uniform(60.0, 120.0)
        noise_sigma = 45.0
    else:
        tint[class_idx % 3] = 80.0 + 40.0 * (class_idx // 3)
        base = 90.0
        noise_sigma = 30.0
    for fi in range(num_frames):
        frame = rng.normal(base, noise_sigma, size=(h, w, 3)).astype(np.float32)
        if pulse_freq is not None:
            # cross_modal_coupling: brightness pulses at the sequence's IMU
            # frequency (instance-level shared structure across modalities).
            # ``pulse_strength`` scales the oscillation amplitude: at 1.0 the
            # hard fixture's pulse (amp ~tint/2 = 4.5-12 gray levels under
            # sigma=45 pixel noise, sampled over 4 frames = 0.16 s of a
            # 0.8-1.4 Hz sine) is UNLEARNABLE by either contrastive loss —
            # measured: SigLIP retrieval top-1 exactly at chance after 30
            # epochs, InfoNCE pinned at ln(B) (docs/BENCHMARKS.md "Article
            # workflow").  Raise it (and frames/clip) to make the coupling
            # learnable-but-nontrivial.
            phase = 2 * np.pi * pulse_freq * fi / fps
            frame += tint * pulse_strength * (0.5 + 0.5 * np.sin(phase))
        else:
            phase = 2 * np.pi * fi / 16.0
            frame += tint * (0.5 + 0.5 * np.sin(phase))
        writer.write(np.clip(frame, 0, 255).astype(np.uint8))
    writer.release()


def make_synthetic_config(dataset_root, output_root, **overrides):
    """The port's ``Config`` pointed at a synthetic dataset, with small sizes (the
    ``tiny_cnn`` tower at 64², 2 pretraining and 3 training epochs); ``overrides`` as
    keyword arguments, ``"section.key"`` for any other field."""
    from ..config import Config

    cfg = Config()
    cfg.paths.base_input = Path(dataset_root)
    cfg.paths.base_output = Path(output_root)
    cfg.paths.__post_init__()
    cfg.model.num_classes = overrides.pop("num_classes", 4)
    cfg.model.video_backbone = overrides.pop("video_backbone", "tiny_cnn")
    cfg.model.video_pretrained = False
    cfg.data.video_resize = overrides.pop("video_resize", (64, 64))
    cfg.training.pretrain_epochs = overrides.pop("pretrain_epochs", 2)
    cfg.training.train_epochs = overrides.pop("train_epochs", 3)
    cfg.training.pretrain_batch_size = overrides.pop("pretrain_batch_size", 4)
    cfg.training.train_batch_size = overrides.pop("train_batch_size", 8)
    cfg.training.num_workers = 0
    cfg.eval.few_shot_samples = overrides.pop("few_shot_samples", [2, 4])
    cfg.eval.few_shot_runs = overrides.pop("few_shot_runs", 2)
    for k, v in overrides.items():
        section, key = k.split(".", 1) if "." in k else (None, k)
        if section:
            setattr(getattr(cfg, section), key, v)
        else:
            raise ValueError(f"Unknown override {k}")
    cfg.paths.ensure_dirs()
    return cfg

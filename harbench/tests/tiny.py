"""Tiny forms of the cells' configurations and workloads, for the CPU: every width cut,
the shapes kept in kind (the ``tpu_cnn`` tower keeps its widths, fixed by its name)."""
from __future__ import annotations

import copy

from harbench import port


def config(name: str):
    c = copy.deepcopy(port.config_file(name))
    c["data"].update(video_frames_per_window=4, video_resize=[32, 32])
    c["model"].update(imu_d_model=32, imu_nhead=4, imu_num_layers=2, fusion_heads=4, num_classes=8,
                      classifier_hidden_dims=[32, 16], video_d_model=48, projection_dim=16, projection_hidden_dim=32)
    if c["tower"]["kind"] == "vit":
        c["model"]["video_backbone"] = "videomae_tiny"
        c["tower"].update(depth=4, d_model=192, heads=3, mlp=768)
    return c


def workload(cell: str):
    w = copy.deepcopy(port.load_json(port.ROOT / "workloads" / f"{cell}.json"))
    w.update(batch=4 if w["driver"] == "pretrain" else 2, keep=2, reference_block=2, warmup_rounds=1)
    return w

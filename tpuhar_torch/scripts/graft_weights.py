"""One-command pretrained-weight graft: a torch/HF checkpoint → the port's model
(``scripts/graft_weights.py``).

    python -m tpuhar_torch.scripts.graft_weights CKPT.{pt,pth,bin,npz} \
        --backbone videomae_base --out outputs/torch/grafted_params.pt \
        [--set data.video_resize=[224,224]]

It loads the state dict (torch or npz; DataParallel/Lightning envelopes are normalized
away), converts it to the flax layout (``models/convert``), grafts it into a freshly
drawn ``FusionClassifier`` with per-leaf shape validation (a checkpoint of another clip
geometry fails loudly), writes the grafted model's state dict (parameters and buffers)
as a ``.pt`` and a per-tensor digest manifest (name, shape, dtype, sha256) for
provenance. ``--dry-run`` validates the checkpoint without building a model: load,
envelope, convert, and a schema/digest report.

Everything here is host work: no tensor goes to a device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Mapping

import numpy as np
import torch


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def tensor_digest(tree) -> dict:
    """``{name: {shape, dtype, sha256[:16]}}`` of a state dict (a torch model's ``{name:
    tensor}``) or of a nested flax-layout tree (names joined with ``/``)."""
    out = {}
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            shape, dtype, raw = list(t.shape), str(t.dtype).removeprefix("torch."), t.view(torch.uint8).numpy()
        else:
            a = np.asarray(leaf)
            shape, dtype, raw = list(a.shape), str(a.dtype), a
        out[path] = {"shape": shape, "dtype": dtype, "sha256": hashlib.sha256(raw.tobytes()).hexdigest()[:16]}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="torch .pt/.pth/.bin or numpy .npz state dict")
    ap.add_argument("--backbone", required=True,
                    help="videomae_{small,base,large} | resnet18 | mobilenet_v2")
    ap.add_argument("--out", default=None,
                    help="write the grafted model's state dict here (.pt); default: "
                         "alongside the checkpoint")
    ap.add_argument("--manifest", default=None,
                    help="write the digest manifest JSON here (default: <out>.manifest.json)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override, e.g. --set data.video_resize=[160,160]")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the checkpoint WITHOUT building a model: "
                         "load + envelope-normalize + layout-convert, then "
                         "print a schema/digest report (fast; catches missing "
                         "keys, wrong variant, final-norm mismatch)")
    return ap.parse_args(argv)


def main(argv=None):
    from ..bridge import init_params, load_variables
    from ..config import Config
    from ..models.convert import convert_video_backbone, graft_model_video_weights, load_state_dict
    from ..models.crossmodal import FusionClassifier

    args = parse_args(argv)
    cfg = Config()
    cfg.model.video_backbone = args.backbone
    for override in args.set:
        key, value = override.split("=", 1)
        cfg.override(key, value)

    if args.dry_run:
        sd = load_state_dict(args.checkpoint)
        print(f"loaded {len(sd)} tensors from {args.checkpoint}", file=sys.stderr)
        converted = convert_video_backbone(sd, cfg)  # raises naming the key on a schema mismatch
        tree = converted[0] if isinstance(converted, tuple) else converted
        report = {
            "dry_run": True,
            "source": str(args.checkpoint),
            "backbone": args.backbone,
            "source_tensors": len(sd),
            "converted_video_encoder_tensors": tensor_digest(tree),
        }
        if isinstance(converted, tuple) and converted[1]:
            report["converted_batch_stats_tensors"] = tensor_digest(converted[1])
        mpath = Path(args.manifest or (args.checkpoint + ".dryrun.json"))
        mpath.write_text(json.dumps(report, indent=1))
        n = len(report["converted_video_encoder_tensors"])
        print(f"DRY RUN OK: checkpoint converts cleanly to {n} {args.backbone} tensors\nreport -> {mpath}")
        return report

    print(f"drawing a {args.backbone} fusion model (host)...", file=sys.stderr)
    variables = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
    print(f"grafting {args.checkpoint} ...", file=sys.stderr)
    params, batch_stats = graft_model_video_weights(
        variables["params"], variables["batch_stats"], cfg, path=args.checkpoint
    )
    print("shape validation OK (every video_encoder leaf matched)", file=sys.stderr)
    model = load_variables(FusionClassifier(cfg, dtype=torch.float32), {"params": params, "batch_stats": batch_stats})
    state = model.state_dict()

    out = Path(args.out or Path(args.checkpoint).with_suffix(".grafted.pt"))
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    manifest = {
        "source": str(args.checkpoint),
        "backbone": args.backbone,
        "out": str(out),
        "video_encoder_tensors": tensor_digest({k: v for k, v in state.items() if k.startswith("video_encoder.")}),
    }
    mpath = Path(args.manifest or (str(out) + ".manifest.json"))
    mpath.write_text(json.dumps(manifest, indent=1))
    n = len(manifest["video_encoder_tensors"])
    print(f"grafted {n} video-encoder tensors -> {out}\nmanifest -> {mpath}")
    return manifest


if __name__ == "__main__":
    main()

"""The card's peaks and the floors that the timing scripts set their times against.

- ``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S`` and ``bound()``: the least time the card
  could take for some work, the larger of its bytes over the memory rate and each
  type's operations over that type's peak (H100 SXM data sheet, dense; f32 products on
  the tensor cores as three TF32 ones at a third of the TF32 rate).
- ``tpucnn_layers``, ``resnet18_int8_layers`` and ``analyze``: the per-layer
  operation and byte counts of the int8 towers at a serving shape
  (``scripts/roofline_int8.py:39-96`` and the layer map of ``scripts/roofline_resnet.py``),
  with the same counts and the card's times: int8 operations at the int8 peak, bytes at
  the memory rate, every output channel count at the full peak.

Keys of ``analyze``'s rows are those of ``scripts/roofline_int8.analyze`` but one: its
``t_mxu_ms`` (operations over a TPU part's peak) is ``t_ops_ms`` here.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
# "tf32x3": f32 products made of three TF32 ones on the tensor cores (the split-TF32 f32
# conv): 495 TFLOP/s of TF32 products, a third of it of f32 work
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32x3": 495e12 / 3}


def bound(bytes_moved: float, ops: Dict[str, float]) -> dict:
    """The least time the card could take: the larger of the bytes over the memory rate
    and each type's operations over its peak rate."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S}
    times.update({kind: n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()})
    by = max(times, key=times.get)
    return {"bound_ms": times[by] * 1e3, "bound_by": "bytes" if by == "bytes" else "operations"}


def tpucnn_layers(widths=(256, 512), blocks=1, patch=16, hw=224) -> List[Tuple]:
    """``(name, H_in, Cin, Cout, k, stride)`` of each conv of the ``tpu_cnn`` tower, per
    frame."""
    layers = [("stem", hw, 3, widths[0], patch, patch)]
    h = hw // patch
    for si, c in enumerate(widths):
        cin = widths[si - 1] if si > 0 else widths[0]
        if si > 0:
            layers.append((f"down{si}", h, cin, c, 3, 2))
            h //= 2
        for bi in range(blocks):
            layers.append((f"s{si}b{bi}a", h, c, c, 3, 1))
            layers.append((f"s{si}b{bi}b", h, c, c, 3, 1))
    return layers


def resnet18_layers() -> List[Tuple]:
    """``(name, H_in, W_in, Cin, Cout, k, stride, count)`` of ResNet-18's convs at 224²,
    per frame (the max-pool 112 → 56 is no conv)."""
    layers = [("stem7x7", 224, 224, 3, 64, 7, 2, 1)]
    prev_c = 64
    for li, (c, hw_out) in enumerate([(64, 56), (128, 28), (256, 14), (512, 7)]):
        hw_in = hw_out if li == 0 else hw_out * 2
        if li == 0:
            layers.append((f"layer{li}.conv3x3", hw_in, hw_in, c, c, 3, 1, 4))
        else:
            layers.append((f"layer{li}.down3x3", hw_in, hw_in, prev_c, c, 3, 2, 1))
            layers.append((f"layer{li}.down1x1", hw_in, hw_in, prev_c, c, 1, 2, 1))
            layers.append((f"layer{li}.conv3x3", hw_out, hw_out, c, c, 3, 1, 3))
        prev_c = c
    return layers


def resnet18_int8_layers() -> List[Tuple]:
    """``resnet18_layers`` flattened to ``(name, H, Cin, Cout, k, stride)``, one entry
    per conv."""
    out = []
    for name, H, _W, cin, cout, k, s, count in resnet18_layers():
        for i in range(count):
            out.append((f"{name}.{i}" if count > 1 else name, H, cin, cout, k, s))
    return out


def analyze(frames_per_step: int, tower: str = "tpu_cnn") -> List[dict]:
    """Per conv of the int8 tower (``tpu_cnn*``, else ResNet-18) at ``frames_per_step``
    frames: its GFLOP, the MB it moves with f32 activations between the convs (the
    baseline int8 program) and with int8 ones (the resident program), and the card's
    times: operations at the int8 peak, each byte count at the memory rate, and the
    floors, the larger of the two."""
    layers = tpucnn_layers() if tower.startswith("tpu_cnn") else resnet18_int8_layers()
    rows = []
    for name, H, cin, cout, k, s in layers:
        ho = H // s
        flops = 2.0 * ho * ho * cin * cout * k * k * frames_per_step
        act_elems = (H * H * cin + ho * ho * cout) * frames_per_step
        w_bytes = k * k * cin * cout * 1.0
        # the baseline program's tensors between convs are f32; the stem reads uint8
        in_bytes = H * H * cin * frames_per_step * (1.0 if name == "stem" else 4.0)
        out_bytes = ho * ho * cout * frames_per_step * 4.0
        b_f32 = in_bytes + out_bytes + w_bytes
        b_int8 = act_elems * 1.0 + w_bytes
        t_ops = flops / PEAK_OPS_PER_S["int8"]
        t_f32, t_int8 = b_f32 / HBM_BYTES_PER_S, b_int8 / HBM_BYTES_PER_S
        rows.append({
            "layer": name, "gflops": flops / 1e9,
            "mb_f32path": b_f32 / 1e6, "mb_residentpath": b_int8 / 1e6,
            "t_ops_ms": t_ops * 1e3,
            "t_mem_f32_ms": t_f32 * 1e3,
            "t_mem_int8_ms": t_int8 * 1e3,
            "floor_f32path_ms": max(t_ops, t_f32) * 1e3,
            "floor_resident_ms": max(t_ops, t_int8) * 1e3,
        })
    return rows

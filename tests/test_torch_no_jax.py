"""Guards of the port: it imports no JAX, CPU tensors take the plain paths, and the
GPU smoke script fails without a CUDA device instead of falling back."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuhar_torch.ops import conv3x3 as conv3x3_module
from tpuhar_torch.ops import flash_lean as flash_lean_module
from tpuhar_torch.ops import fused_window as fused_window_module
from tpuhar_torch.ops.conv3x3 import conv3x3_bn_act, conv3x3_i8, conv3x3_i8_reference
from tpuhar_torch.ops.flash_lean import flash_lean
from tpuhar_torch.ops.fused_window import featurize_windows_auto
from tpuhar_torch.ops.stem import int8_gemm, int8_gemm_reference, stem_gemm_u8, stem_gemm_u8_reference

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
# JAX, and the host libraries a machine with the card need not have: the port's modules
# and chip_smoke import none of them (pandas, OpenCV and sklearn only inside the
# functions that read a DataFrame, decode a clip or write a report)
for name in ("jax", "jaxlib", "flax", "optax", "pandas", "cv2", "sklearn", "matplotlib", "transformers"):
    sys.modules[name] = None  # any import of them now raises ImportError
import tpuhar_torch
names = [m.name for m in pkgutil.walk_packages(tpuhar_torch.__path__, "tpuhar_torch.")]
for name in ("tpuhar_torch.losses", "tpuhar_torch.train.steps", "tpuhar_torch.train.loop",
             "tpuhar_torch.train.factory", "tpuhar_torch.train.checkpoint", "tpuhar_torch.train.optim",
             "tpuhar_torch.ops.augment", "tpuhar_torch.eval.metrics", "tpuhar_torch.utils.profiling",
             "tpuhar_torch.serving", "tpuhar_torch.serving_quant", "tpuhar_torch.ops.quant_vit",
             "tpuhar_torch.models.convert", "tpuhar_torch.data.manifest", "tpuhar_torch.data.loader",
             "tpuhar_torch.data.frames", "tpuhar_torch.eval.calibration", "tpuhar_torch.eval.evaluator",
             "tpuhar_torch.eval.fewshot_parallel", "tpuhar_torch.eval.zeroshot", "tpuhar_torch.eval.ablation",
             "tpuhar_torch.ood", "tpuhar_torch.data.preprocess", "tpuhar_torch.data.synthetic",
             "tpuhar_torch.data.raw_stream", "tpuhar_torch.report.tables", "tpuhar_torch.report.plots",
             "tpuhar_torch.utils", "tpuhar_torch.cli", "tpuhar_torch.__main__"):
    assert name in names, name
for name in names:
    importlib.import_module(name)
import chip_smoke
jax_package = sorted(m for m in sys.modules if m == "tpuhar" or m.startswith("tpuhar."))
assert not jax_package, jax_package
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    # every module of the package was imported, the training ones (losses, train/*,
    # ops/augment, eval/metrics, utils/profiling), the evaluate stage's and the
    # pipeline's (data preparation, reports, the command line) included
    assert int(proc.stdout.split()[-1]) >= 48


def _spy(monkeypatch, module, name: str) -> list:
    """Replace ``module.name`` with a spy that calls it and records ``(args, kwargs,
    result)`` of each call."""
    real, calls = getattr(module, name), []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


def test_cpu_tensors_take_the_plain_paths(monkeypatch):
    """Each wrapper, given CPU tensors, calls its plain version on those very tensors
    and returns that call's result, bit for bit, and launches nothing. The spies hold
    the result of the one plain call the wrapper made: a second, separate plain call
    would be another CPU computation, which MKL and oneDNN need not round the same."""
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.normal(0, 8000, (2, 250, 6)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 32, 16)).astype(np.float32))
    scale, bias = torch.ones(16), torch.zeros(16)
    q, kv = (torch.from_numpy(rng.standard_normal((1, 2, 40, 32)).astype(np.float32)) for _ in range(2))
    plain = {
        "featurize": _spy(monkeypatch, fused_window_module, "featurize_windows"),
        "conv": _spy(monkeypatch, conv3x3_module, "conv3x3_bn_act_reference"),
        "flash": _spy(monkeypatch, flash_lean_module, "flash_lean_reference"),
    }

    def the_plain_call(what, got, args, kwargs):
        (called_args, called_kwargs, result), = plain[what]
        plain[what].clear()
        assert len(called_args) == len(args), what
        for a, b in zip(called_args, args):  # the very tensors; scalars equal
            assert a is b if isinstance(b, torch.Tensor) else a == b, what
        assert called_kwargs == kwargs, what
        assert torch.equal(got, result) and got.dtype == result.dtype, what

    before = featurize_windows_auto.launches, conv3x3_bn_act.launches, flash_lean.launches
    defaults = dict(kernel_size=5, normalize=True, racc=16384.0, rgyro=16.4)
    the_plain_call("featurize", featurize_windows_auto(raw), (raw,), defaults)
    # the CPU path takes what the kernel refuses: k=3, f32, C not a multiple of 16 ...
    the_plain_call("featurize", featurize_windows_auto(raw, kernel_size=3), (raw,), {**defaults, "kernel_size": 3})
    the_plain_call("conv", conv3x3_bn_act(x, k, scale, bias), (x, k, scale, bias, None, True), {})
    # head_dim 32 and f32 on the CPU: the plain attention
    the_plain_call("flash", flash_lean(q, kv, kv), (q, kv, kv, 1.0 / 32**0.5), {})
    bf = [t.to(torch.bfloat16) for t in (q, kv)]
    the_plain_call("flash", flash_lean(bf[0], bf[1], bf[1]), (bf[0], bf[1], bf[1], 1.0 / 32**0.5), {})
    # ... and launches nothing
    assert (featurize_windows_auto.launches, conv3x3_bn_act.launches, flash_lean.launches) == before


def test_cpu_tensors_take_the_plain_int8_paths():
    """The int8 stem, GEMM and conv on CPU tensors, at shapes and pads the kernels refuse
    (K not a multiple of 64, C0 and C not multiples of 32, unequal pads per axis), give
    their plain results and launch nothing."""
    rng = np.random.default_rng(1)
    col = torch.from_numpy(rng.integers(0, 256, (2, 3, 3, 48), dtype=np.uint8))
    w = torch.from_numpy(rng.integers(-127, 128, (24, 48), dtype=np.int8))  # (C0, K)
    scale, bias = torch.full((24,), 1e-3), torch.zeros(24)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 5, 5, 24), dtype=np.int8))
    wc = torch.from_numpy(rng.integers(-127, 128, (40, 9 * 24), dtype=np.int8))
    res = torch.from_numpy(rng.integers(-127, 128, (2, 3, 3, 40), dtype=np.int8))
    sc, bc = torch.full((40,), 1e-4), torch.zeros(40)
    before = stem_gemm_u8.launches, conv3x3_i8.launches, int8_gemm.launches
    assert torch.equal(
        stem_gemm_u8(col, w, scale, bias, out_scale=0.1),
        stem_gemm_u8_reference(col, w, scale, bias, out_scale=0.1),
    )
    kw = dict(stride=2, residual=res, res_scale=0.02, out_scale=0.05)
    assert torch.equal(conv3x3_i8(x, wc, sc, bc, **kw), conv3x3_i8_reference(x, wc, sc, bc, **kw))
    # explicit pads the kernel refuses ((0, 2) at stride 2 on 5²: a side of 3 it does write,
    # but unequal pads per axis) and a K of 147 (ResNet-18's unpadded 7·7·3)
    pads = [(0, 2), (1, 1)]
    assert torch.equal(conv3x3_i8(x, wc, sc, bc, padding=pads, **kw), conv3x3_i8_reference(x, wc, sc, bc, padding=pads, **kw))
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 5, 147), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (24, 147), dtype=np.int8))
    assert torch.equal(int8_gemm(xq, wq, scale, bias, relu=True), int8_gemm_reference(xq, wq, scale, bias, relu=True))
    assert (stem_gemm_u8.launches, conv3x3_i8.launches, int8_gemm.launches) == before


_INT8_TOWERS = """
import sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None
import numpy as np, torch
from tpuhar_torch.bridge import init_params
from tpuhar_torch.config import Config
from tpuhar_torch.serving_quant import build_quantized_forward
for backbone, resident in (("videomae_tiny", False), ("resnet18", False), ("resnet18", True)):
    cfg = Config()
    m = cfg.model
    m.video_backbone, m.video_d_model, m.compute_dtype, m.head_norm = backbone, 32, "float32", "layer"
    m.imu_d_model, m.imu_nhead, m.imu_num_layers, m.fusion_heads, m.num_classes = 32, 4, 1, 4, 4
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 2
    params = init_params(cfg, torch.Generator().manual_seed(0))
    clips = np.random.default_rng(0).integers(0, 256, (2, 2, 32, 32, 3), dtype=np.uint8)
    fn = build_quantized_forward(cfg, params, clips, device="cpu", resident=resident)
    out = fn(torch.zeros(2, 250, 6), torch.from_numpy(clips))
    assert out["logits"].shape == (2, 4) and torch.isfinite(out["logits"]).all(), backbone
jax_package = sorted(m for m in sys.modules if m == "tpuhar" or m.startswith("tpuhar."))
assert not jax_package, jax_package
print("ok")
"""


def test_int8_towers_serve_without_jax():
    """The int8 ViT and ResNet-18 serving paths (calibration, quantization, logit
    recalibration and the forward) run with JAX and flax unimportable and load no
    module of the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _INT8_TOWERS], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        chip_smoke.require_cuda()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        chip_smoke.main()
    assert capsys.readouterr().out == ""  # no result printed


def test_profile_step_fails_without_cuda(monkeypatch, capsys):
    from tpuhar_torch import profile_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profile_step.main()
    assert capsys.readouterr().out == ""  # no table printed

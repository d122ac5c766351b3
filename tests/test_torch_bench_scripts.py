"""The timing and decomposition scripts of ``tpuhar_torch/scripts/``, the card's floors
(``tpuhar_torch/utils/roofline.py``) and the last two public functions, against the JAX
package, on the CPU at tiny sizes.

- ``CrossModalModel.encode_imu`` against the JAX package's ``apply(..., method=
  "encode_imu")`` on the same variables (carried across with ``bridge``), in f32: the
  embedding and the tokens to atol 1e-5.
- ``train.checkpoint.restore_params`` reads back what ``save_params`` wrote, bit for
  bit, and raises on a missing or an extra key and on a wrong shape.
- ``utils.roofline``: per layer, the operation and byte counts of
  ``scripts/roofline_int8.tpucnn_layers``/``analyze`` (``tpu_cnn`` and ResNet-18), to
  rel 1e-12; at 4096 frames the resident floors of ``s0b0a`` and ``stem`` are the int8
  conv's and the stem's bounds of ``PERF.md`` §6 (rows 2' and 3), 0.4785 and 0.2455 ms,
  to 4 digits.
- ``perf_int8_stages``' prefix 5 is ``quant_tpucnn_forward_resident`` bit for bit, on 2
  frames of 224² through the flagship tower's tree quantized by the JAX package.
- ``bench_serving_stream``: the JAX script's result keys, and its rate names but the
  recorded rename (``"tunnel-upload"`` → ``"upload"``); ``predict_stream``'s logits equal
  ``predict``'s.
- ``generate_tables --demo`` writes the CSV tables the JAX package's ``generate_tables``
  writes, byte for byte.
- Each script's ``--help``, and its ``run(..., cpu=True)`` at a tiny size returning
  its keys with finite numbers.
"""
import ast
import importlib
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuhar_torch.bridge import init_params, load_variables, quantized_tree_from_numpy
from tpuhar_torch.entry import flagship_config
from tpuhar_torch.models.crossmodal import CrossModalModel
from tpuhar_torch.ops.quant import calibrate_tpucnn, quant_tpucnn_forward_resident
from tpuhar_torch.train.checkpoint import restore_params, save_params
from tpuhar_torch.utils import roofline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("bench_train", "bench_loader", "bench_preprocess", "bench_serving_stream", "perf_decompose",
           "perf_nonvideo", "perf_quant", "perf_int8_stages", "perf_vit_stages", "perf_sweep",
           "perf_tpucnn_variants", "perf_trace", "generate_tables")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _imu_config():
    from tpuhar.config import Config

    cfg = Config()
    m = cfg.model
    m.video_backbone, m.video_pretrained, m.video_d_model = "tiny_cnn", False, 32
    m.imu_d_model, m.imu_nhead, m.imu_num_layers = 32, 4, 2
    m.projection_dim, m.projection_hidden_dim = 16, 32
    m.compute_dtype = "float32"
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 2
    return cfg


@pytest.fixture(scope="module")
def crossmodal():
    """IMU windows, the JAX package's tiny ``CrossModalModel.encode_imu`` of them on the
    variables of its IMU encoder (all that ``encode_imu`` reads), and the port's model:
    weights of ``bridge.init_params``, its IMU encoder holding JAX's."""
    from tpuhar.models.crossmodal import CrossModalModel as JaxCrossModal

    cfg = _imu_config()
    jmodel = JaxCrossModal(cfg)
    imu = np.random.default_rng(0).standard_normal((3, 6, 250)).astype(np.float32)

    def init_and_encode(key, x):
        variables = jmodel.init(key, x, method="encode_imu")
        return variables, jmodel.apply(variables, x, method="encode_imu")

    variables, want = jax.device_get(jax.jit(init_and_encode)(jax.random.PRNGKey(0), imu))
    model = load_variables(CrossModalModel(cfg, dtype=torch.float32),
                           init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel)).eval()
    load_variables(model.imu_encoder, {"params": variables["params"]["imu_encoder"]})
    return imu, want, model


def test_encode_imu_matches_jax(crossmodal):
    imu, (want_feat, want_tokens), model = crossmodal
    with torch.no_grad():
        feat, tokens = model.encode_imu(torch.from_numpy(imu))
    assert feat.shape == (3, 32) and tokens.shape == tuple(np.asarray(want_tokens).shape)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["round_trip", "missing_key", "extra_key", "wrong_shape"])
def test_restore_params_reads_save_params(crossmodal, tmp_path, case):
    model = crossmodal[2]
    save_params(tmp_path / "final_model_params", model)
    template = dict(model.named_parameters())
    if case == "round_trip":
        got = restore_params(tmp_path / "final_model_params", template)
        assert list(got) == list(template)
        for name, p in template.items():
            assert got[name].dtype == p.dtype and torch.equal(got[name], p.detach()), name
        return
    name = next(iter(template))
    if case == "missing_key":  # the template asks for a key the file lacks
        template["not_in_the_file"] = template[name]
    elif case == "extra_key":  # the file holds a key the template lacks
        del template[name]
    else:
        template[name] = torch.zeros(template[name].numel() + 1)
    with pytest.raises(ValueError if case == "wrong_shape" else KeyError):
        restore_params(tmp_path / "final_model_params", template)


@pytest.mark.parametrize("tower", ["tpu_cnn", "resnet18"])
def test_roofline_counts_match_jax(tower, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    jax_roofline = _load("jax_roofline_int8", ROOT / "scripts" / "roofline_int8.py")
    if tower == "tpu_cnn":
        assert roofline.tpucnn_layers() == jax_roofline.tpucnn_layers()
    else:
        assert roofline.resnet18_int8_layers() == jax_roofline.resnet18_int8_layers()
    want, got = jax_roofline.analyze(4096, tower), roofline.analyze(4096, tower)
    assert [r["layer"] for r in got] == [r["layer"] for r in want]
    for g, w in zip(got, want):
        for key in ("gflops", "mb_f32path", "mb_residentpath"):
            assert g[key] == pytest.approx(w[key], rel=1e-12), (g["layer"], key)
        # the card's times: the counts over its int8 peak and memory rate
        assert g["t_ops_ms"] == pytest.approx(g["gflops"] * 1e9 / 1979e12 * 1e3, rel=1e-12)
        assert g["t_mem_int8_ms"] == pytest.approx(g["mb_residentpath"] * 1e6 / 3.35e12 * 1e3, rel=1e-12)
        assert g["floor_resident_ms"] == max(g["t_ops_ms"], g["t_mem_int8_ms"])
        assert "t_mxu_ms" not in g


def test_floors_equal_the_kernel_bounds():
    """PERF.md §6: the int8 conv at 4096×14²×256→256 is bound by its operations at
    0.4785 ms, the stem at 4096·196×768→256 by its bytes at 0.2455 ms."""
    floors = {r["layer"]: r for r in roofline.analyze(4096)}
    assert round(floors["s0b0a"]["floor_resident_ms"], 4) == 0.4785
    assert floors["s0b0a"]["t_ops_ms"] > floors["s0b0a"]["t_mem_int8_ms"]
    assert round(floors["stem"]["floor_resident_ms"], 4) == 0.2455
    assert floors["stem"]["t_mem_int8_ms"] > floors["stem"]["t_ops_ms"]
    assert roofline.bound(0.0, {"int8": floors["s0b0a"]["gflops"] * 1e9}) == {
        "bound_ms": floors["s0b0a"]["floor_resident_ms"], "bound_by": "operations"}


def test_int8_prefix_five_is_the_served_forward():
    from tpuhar.ops import quant as Q
    from tpuhar.ops.stem import to_patch_major
    from tpuhar.ops.video import IMAGENET_MEAN, IMAGENET_STD, normalize_clip
    from tpuhar_torch.scripts import perf_int8_stages

    u8 = (np.random.default_rng(5).random((2, 224, 224, 3)) * 255).astype(np.uint8)
    calib = np.array(normalize_clip(jnp.asarray(u8[:, :64, :64])[None])[0])
    # the flagship tower's flax-layout weights, its BatchNorm parameters and statistics drawn
    variables = init_params(flagship_config(), torch.Generator().manual_seed(5))
    params = variables["params"]["video_encoder"]["backbone"]
    stats = variables["batch_stats"]["video_encoder"]["backbone"]
    rng = np.random.default_rng(5)
    for name in [n for n in params if n.endswith("_bn")]:
        n = params[name]["scale"].shape[0]
        params[name] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                        "bias": rng.normal(0, 0.1, n).astype(np.float32)}
        stats[name] = {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                       "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    # the sites' statistics from the port's calibration (``tests/test_torch_quant.py``
    # holds it to the JAX package's); the tree is the JAX package's quantization, jitted
    act = calibrate_tpucnn(params, stats, torch.from_numpy(calib))
    q = quantized_tree_from_numpy(jax.device_get(jax.jit(
        lambda p, s: Q.quantize_tpucnn(p, s, act, input_fold=(IMAGENET_MEAN, IMAGENET_STD)))(params, stats)))
    frames = torch.from_numpy(np.ascontiguousarray(to_patch_major(u8, 16)))
    assert perf_int8_stages.units(q) == ["stem", "s0b0", "down1", "s1b0", "pool"]
    outs = [perf_int8_stages.resident_prefix(q, frames, n) for n in range(1, 6)]
    assert [o.dtype for o in outs] == [torch.int8] * 3 + [torch.float32] * 2
    assert [tuple(o.shape) for o in outs] == [(2, 14, 14, 256), (2, 14, 14, 256), (2, 7, 7, 512), (2, 7, 7, 512),
                                              (2, 512)]
    want = quant_tpucnn_forward_resident(q, frames)
    assert torch.equal(outs[-1], want)
    result = perf_int8_stages.run(2, cpu=True, iters=1, trials=1, tree=q)
    assert set(result) == {"bench", "frames_per_step", "cumulative_ms", "stages"}
    assert [r["unit"] for r in result["stages"]] == ["stem", "+ s0b0", "+ down1", "+ s1b0", "+ pool"]
    assert list(result["cumulative_ms"]) == ["1", "2", "3", "4", "5"]


def _jax_dict_keys(path: Path, name: str) -> set:
    """The string keys of the dict literal assigned to ``name`` in a script."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name for t in node.targets):
            if isinstance(node.value, ast.Dict):
                return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict {name} in {path}")


def test_bench_serving_stream_keys_and_stream_logits(tmp_path):
    from tpuhar_torch.scripts import bench_serving_stream

    jax_script = ROOT / "scripts" / "bench_serving_stream.py"
    rates = _jax_dict_keys(jax_script, "rates")
    assert set(bench_serving_stream.RATE_NAMES) == (rates - {"tunnel-upload"}) | {"upload"}
    outputs = {}
    args = bench_serving_stream.parse_args(["--quick", "--cpu", "--root", str(tmp_path / "bss"), "--batch", "4",
                                            "--reuse-fixture", str(tmp_path / "none"), "--min-windows", "8"])
    result = bench_serving_stream.run(args, bench_iters=1, trials=1, fixture_size=(2, 1, 300), outputs=outputs)
    assert set(result) == _jax_dict_keys(jax_script, "result")
    assert result["bound"] in bench_serving_stream.RATE_NAMES and result["platform"] == "cpu"
    assert result["windows"] >= 8 and len(outputs["stream"]) == len(outputs["sequential"]) >= 2
    for seq, stream in zip(outputs["sequential"], outputs["stream"]):
        np.testing.assert_array_equal(stream, seq)
    _finite(result)


def test_generate_tables_demo_matches_jax(tmp_path):
    from tpuhar_torch.scripts import generate_tables

    jax_tables = _load("jax_generate_tables", ROOT / "generate_tables.py")
    jax_tables.main(["--demo", "--results-dir", str(tmp_path / "jax")])
    generate_tables.main(["--demo", "--results-dir", str(tmp_path / "torch")])
    want = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert want and sorted(p.name for p in (tmp_path / "torch").glob("*.csv")) == want
    for name in want:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_help(name, capsys):
    module = importlib.import_module(f"tpuhar_torch.scripts.{name}")
    with pytest.raises(SystemExit) as e:
        module.parse_args(["--help"])
    assert e.value.code == 0 and "usage:" in capsys.readouterr().out


def _finite(obj) -> int:
    if isinstance(obj, dict):
        return sum(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return sum(_finite(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        assert math.isfinite(obj), obj
        return 1
    return 0


def _tiny():
    """The flagship configuration at 2 frames of 32², its IMU encoder and fusion narrow."""
    cfg = flagship_config()
    cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 2
    m = cfg.model
    m.imu_num_layers, m.imu_d_model, m.imu_nhead, m.fusion_heads, m.video_d_model = 1, 32, 4, 4, 48
    return cfg


TINY_RUNS = {
    "bench_train": (lambda m: m.run(2, cpu=True, steps=1, trials=1, config=_tiny()),
                    {"bench", "batch", "device", "steps"}),
    "bench_preprocess": (lambda m: m.run(cpu=True, n_sequences=3, lengths=(300, 600), trials=1),
                         {"bench", "sequences", "windows", "device", "host", "device_batched"}),
    # the process pool's rate (its spawn takes seconds here) runs in chip_smoke.py's phase 26; the pool
    # itself is tests/test_torch_loader_backends.py's
    "bench_loader": (lambda m: m.run(cpu=True, workers=(), threads=(1, 2), num_classes=2, samples_per_class=1,
                                     seq_len=300, size=32, frames=2),
                     {"bench", "windows", "device", "fixture", "imu_windows_per_s", "clips_per_s"}),
    "perf_decompose": (lambda m: m.run(2, cpu=True, iters=1, trials=1, config=_tiny()),
                       {"bench", "batch", "device", "ms"}),
    "perf_nonvideo": (lambda m: m.run(2, cpu=True, iters=1, trials=1, config=_tiny()), {"bench", "batch", "ms"}),
    "perf_quant": (lambda m: m.run(2, cpu=True, iters=1, trials=1, config=_tiny()),
                   {"bench", "batch", "device", "bf16_ms", "int8_ms", "bf16_inf_per_s", "int8_inf_per_s", "speedup"}),
    "perf_vit_stages": (lambda m: m.run(2, cpu=True, backbone="videomae_tiny", frames=2, size=32, iters=1, trials=1),
                        {"bench", "batch", "device", "null_ms", "units_ms", "floors_ms", "model_est_ms",
                         "model_floor_ms", "full_model_ms"}),
    "perf_sweep": (lambda m: m.run(("resnet18:2", "videomae_tiny:2"), cpu=True, iters=1, trials=1, config=_tiny()),
                   {"backbone", "batch", "throughput", "step_ms", "build_s"}),
    "perf_tpucnn_variants": (lambda m: m.run(("256,512", "384,512"), cpu=True, batch=2, iters=1, trials=1,
                                             config=_tiny()),
                             {"widths", "backbone", "step_ms", "inf_per_s"}),
}


@pytest.mark.parametrize("name", list(TINY_RUNS))
def test_script_runs_on_the_cpu(name):
    run, keys = TINY_RUNS[name]
    result = run(importlib.import_module(f"tpuhar_torch.scripts.{name}"))
    rows = result if isinstance(result, list) else [result]
    assert rows and all(set(r) == keys for r in rows), [sorted(r) for r in rows]
    assert _finite(result) > 0


NO_TRIAL_RUNS = {
    "perf_nonvideo": lambda m: m.run(2, cpu=True, iters=1, trials=0, config=_tiny()),
    "perf_vit_stages": lambda m: m.run(2, cpu=True, backbone="videomae_tiny", frames=2, size=32, iters=1, trials=0),
    "bench_preprocess": lambda m: m.run(cpu=True, n_sequences=2, lengths=(300, 400), trials=0),
}


@pytest.mark.parametrize("name", list(NO_TRIAL_RUNS))
def test_a_run_with_no_trial_prints_null(name, capsys):
    """A time no trial measured is null in the JSON, never a number."""
    import json

    result = NO_TRIAL_RUNS[name](importlib.import_module(f"tpuhar_torch.scripts.{name}"))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    times = {"perf_nonvideo": lambda r: r["ms"].values(),
             "perf_vit_stages": lambda r: [*r["units_ms"].values(), r["null_ms"], r["model_est_ms"], r["full_model_ms"]],
             "bench_preprocess": lambda r: [v for k in ("host", "device_batched") for v in r[k].values()]}[name]
    assert all(t is None for t in times(printed))


def test_perf_trace_writes_a_trace_and_its_top_ops(tmp_path):
    from tpuhar_torch.scripts import perf_trace

    result = perf_trace.run(cpu=True, batch=2, steps=1, top=5, config=_tiny(), logdir=tmp_path / "trace")
    assert set(result) == {"bench", "backbone", "batch", "steps", "trace", "device", "device_ms", "ops", "busy", "top"}
    assert Path(result["trace"]).stat().st_size > 0 and len(result["top"]) == 5
    assert result["top"] == sorted(result["top"], key=lambda r: -r["ms"])
    _finite(result)


def test_one_home_for_the_card_peaks():
    """``chip_smoke.py`` and ``time_fused_window`` read the peaks of ``utils/roofline``."""
    import chip_smoke
    from tpuhar_torch import time_fused_window

    assert chip_smoke.bound is roofline.bound
    assert time_fused_window.HBM_BYTES_PER_S is roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_OPS_PER_S == {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32x3": 495e12 / 3}
    for path in (ROOT / "chip_smoke.py", ROOT / "tpuhar_torch" / "time_fused_window.py"):
        assert "3.35e12" not in path.read_text() and "1979e12" not in path.read_text(), path

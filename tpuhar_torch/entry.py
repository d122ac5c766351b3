"""The entry points of the port: the serving forwards (twins of
``__graft_entry__._build_forward``), the pretraining task and the classification
stage's tasks.

Raw IMU counts ``(B, 250, 6)`` and a uint8 clip go through the fused window
featurizer, the IMU transformer, the video tower (ImageNet normalization folded into
its stem), two rounds of cross-attention fusion and the LayerNorm classifier head,
giving logits, MSP and energy OOD scores and the fused embedding. ``build_forward``
runs the tower in the compute dtype: the flagship's ``tpu_cnn`` (``flagship_config``,
the clip shipped patch-major) or the ``videomae_base`` ViT (``vit_config``, the clip
NHWC, attention through the flash kernel); ``build_int8_forward`` runs a tower's int8
PTQ form (``serving_quant``: ``tpu_cnn``, ResNet-18 or a ViT), for ``tpu_cnn`` the
program the JAX package's ``bench.py`` reports as its headline. ``build_pretrain_task`` builds the cross-modal SigLIP
pretraining of ``pretrain_config`` (``tpuhar/cli.py: Pipeline.run_pretraining``);
``build_classification_task`` the IMU classifier's linear probe or finetune of
``classify_config`` (``Pipeline.run_classification``), ``build_video_task`` and
``build_fusion_task`` the video-only and fusion classifiers. ``entry`` is
``__graft_entry__.entry``'s twin; ``dryrun_multichip`` its ``dryrun_multichip``: one
fully sharded fusion train step and the bf16 and int8 engines over a dp × tp mesh, then
over a pure-dp mesh, in spawned ranks.
"""
from __future__ import annotations

import copy
import socket
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .bridge import init_params, load_variables
from .config import Config
from .models.crossmodal import CrossModalModel, FusionClassifier, IMUClassifier, VideoClassifier
from .ood import energy_score, msp_score
from .ops.fold import fold_normalization
from .ops.conv3x3 import conv3x3_bn_act, conv3x3_bn_act_f32, conv3x3_i8
from .ops.flash_lean import (
    flash_lean,
    flash_lean_bwd_dkv,
    flash_lean_bwd_dkv_f32,
    flash_lean_bwd_dq,
    flash_lean_bwd_dq_f32,
    flash_lean_f32,
)
from .ops.fused_window import featurize_windows_auto
from .ops.stem import int8_gemm, stem_gemm_u8, to_patch_major
from .ops.video import clip_stats, normalize_clip
from .train import factory


def flagship_config(compute_dtype: str = "bfloat16", *, tiny: bool = False):
    """The flagship serving configuration (``__graft_entry__._flagship_config``) in
    the form the port runs: the ``tpu_cnn`` tower with its residual convs fused
    (``conv_backend="pallas"`` in the JAX package). ``tiny`` makes the JAX package's
    dry-run sizes: the ``videomae_tiny`` tower at d=64, the IMU encoder at d=64 with 4
    heads and 2 layers, 4 fusion heads, 8 classes, 4 frames of 32²."""
    cfg = Config()
    m = cfg.model
    m.video_backbone = "tpu_cnn"
    m.video_pretrained = False
    m.compute_dtype = compute_dtype
    m.head_norm = "layer"
    m.conv_backend = "pallas"
    if tiny:
        m.video_backbone, m.video_d_model = "videomae_tiny", 64
        m.imu_d_model, m.imu_nhead, m.imu_num_layers = 64, 4, 2
        m.fusion_heads, m.num_classes = 4, 8
        cfg.data.video_resize, cfg.data.video_frames_per_window = (32, 32), 4
    return cfg


def vit_config(compute_dtype: str = "bfloat16"):
    """The ``videomae_base`` fusion model as the JAX package serves it
    (``InferenceEngine(fast_gelu=True, fast_attention=True)``): the tanh GELU and the
    flash attention, with the flagship's IMU encoder, fusion and head. One Hopper
    kernel serves both of the JAX package's flash kernels at every block size, so the
    port reads neither ``flash_kernel`` nor ``flash_block_q``/``flash_block_k``."""
    cfg = Config()
    m = cfg.model
    m.video_backbone = "videomae_base"
    m.video_pretrained = False
    m.compute_dtype = compute_dtype
    m.head_norm = "layer"
    m.gelu_approximate = True
    m.use_flash_attention = True
    return cfg


def pretrain_config():
    """The pretraining stage's configuration: ``Config()`` (``videomae_base``, bf16
    compute with f32 parameters, BatchNorm projection heads, the exact-erf GELU that
    training keeps, IMU dropout 0.1, SigLIP with trainable scalars, batch 16, AdamW at
    1e-4 with weight decay 0.01, clipping at 1.0) with the flash attention of the stock
    Pallas kernel (``flash_kernel="library"``, the one whose backward the TPU runs) and
    weights drawn from a seed (``video_pretrained=False``)."""
    cfg = Config()
    m = cfg.model
    m.use_flash_attention = True
    m.flash_kernel = "library"
    m.video_pretrained = False
    return cfg


def _params(cfg, params: Optional[Dict], seed: int, model_cls) -> Dict:
    """``params``, or a tree of ``model_cls`` drawn from ``torch.Generator().manual_seed(seed)``."""
    return init_params(cfg, torch.Generator().manual_seed(seed), model_cls) if params is None else params


def build_pretrain_task(cfg, *, device, seed: int = 0, params: Optional[Dict] = None, steps_per_epoch: int,
                        mesh=None):
    """The pretraining task of ``cfg`` on ``device`` (``train/factory.Task``: the model
    with f32 master weights, its ``TrainState`` and ``train_step``/``eval_step``).

    ``params`` is a flax-layout variable tree of ``CrossModalModel`` (``None`` draws one
    with ``init_params`` from ``torch.Generator().manual_seed(seed)``);
    ``steps_per_epoch`` sets the schedule. Batches are ``{"imu": (B, C, T) featurized f32,
    "video": (B, T, H, W, 3) uint8}`` on ``device``. ``mesh`` (``parallel.mesh``) makes
    the steps data parallel over it."""
    return factory.build_crossmodal_task(cfg, steps_per_epoch, _params(cfg, params, seed, CrossModalModel),
                                         device=device, mesh=mesh)


def classify_config():
    """The classification stage's configuration: the flagship's IMU classifier
    (``flagship_config``: the transformer encoder at d=128 with 4 layers and 8 heads on
    91 tokens, the LayerNorm head 256 → 128 → 32 classes with dropout 0.3, bf16 compute
    with f32 masters) trained at ``train_batch_size`` 64: AdamW with weight decay 0.01,
    the head at 1e-3 and the encoder at 1e-6 (finetune), each decaying to 1e-7 over
    ``train_epochs``, clipping at 1.0."""
    cfg = flagship_config()
    cfg.training.train_batch_size = 64
    return cfg


def build_classification_task(
    cfg,
    mode: str,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    steps_per_epoch: int,
    encoder_params: Optional[Dict] = None,
    encoder_batch_stats: Optional[Dict] = None,
    mesh=None,
):
    """The IMU classifier's task in ``mode`` ("linear_probe" or "finetune") on ``device``.

    ``params`` is an ``IMUClassifier`` tree (``None`` draws one from ``seed``);
    ``encoder_params`` (and ``encoder_batch_stats``) replace its ``imu_encoder``, such as
    the subtree of a pretraining state's ``bridge.variables_to_numpy``. Batches are
    ``{"imu": (B, C, T) featurized f32, "label": (B,) int}`` on ``device`` (plus
    ``"n_valid"`` for ``predict_step``)."""
    return factory.build_classification_task(
        cfg, mode, steps_per_epoch, _params(cfg, params, seed, IMUClassifier),
        encoder_params=encoder_params, encoder_batch_stats=encoder_batch_stats, device=device, mesh=mesh,
    )


def build_video_task(cfg, *, device, seed: int = 0, params: Optional[Dict] = None, steps_per_epoch: int,
                     mesh=None):
    """The video-only classifier's task on ``device`` (``params`` a ``VideoClassifier``
    tree, ``None`` draws one from ``seed``). Batches are ``{"video": (B, T, H, W, 3)
    uint8, "label"}``."""
    return factory.build_video_task(cfg, steps_per_epoch, _params(cfg, params, seed, VideoClassifier), device=device,
                                    mesh=mesh)


def build_fusion_task(
    cfg,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    steps_per_epoch: int,
    encoder_params: Optional[Dict] = None,
    mesh=None,
):
    """The fusion classifier's task on ``device`` (``params`` a ``FusionClassifier``
    tree, ``None`` draws one from ``seed``; ``encoder_params`` replaces its
    ``imu_encoder``). Batches are ``{"imu", "video" (B, T, H, W, 3) uint8, "label"}``."""
    return factory.build_fusion_task(
        cfg, steps_per_epoch, _params(cfg, params, seed, FusionClassifier),
        encoder_params=encoder_params, device=device, mesh=mesh,
    )


def featurize(cfg, imu_raw: torch.Tensor) -> torch.Tensor:
    """The serving featurization of ``cfg.data``: raw counts ``(B, T, 6)`` → ``(B, 6,
    T)`` f32 (``ops/fused_window.featurize_windows_auto``)."""
    d = cfg.data
    return featurize_windows_auto(
        imu_raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu, racc=d.Racc, rgyro=d.Rgyro,
    )


def fusion_program(cfg, params: Dict, *, device, fold_normalize: bool = True):
    """The fusion model of ``cfg`` on ``device`` in ``cfg.model.compute_dtype``, as
    ``(fn(imu_raw, video_u8) -> (logits, embeddings), folded)``: ``params`` is a
    flax-layout tree before any folding; ``folded`` says whether the ImageNet
    normalization went into the stem (the clip is then consumed raw), else the clip is
    normalized on the device with statistics made here, once. ``cfg`` is used as it is
    (``build_forward`` and ``serving.InferenceEngine`` make their overrides first)."""
    dtype = getattr(torch, cfg.model.compute_dtype)
    folded = False
    if fold_normalize:
        params, folded = fold_normalization(params, cfg)
    model = load_variables(FusionClassifier(cfg, dtype=dtype), params).to(device).eval()
    mean, std = clip_stats(device)

    @torch.inference_mode()
    def run(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        video = video_u8.to(dtype) if folded else normalize_clip(video_u8, mean=mean, std=std)
        return model(featurize(cfg, imu_raw), video)

    return run, folded


def build_forward(
    cfg,
    batch: int,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    fold_normalize: bool = True,
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]], Tuple]:
    """Returns ``(fn(imu_raw, video_u8) -> dict, example_args)``; fn closes over the
    model on ``device`` in ``cfg.model.compute_dtype``.

    ``params`` is a flax-layout variable tree (``bridge``) before any folding, such
    as JAX's ``forward._variables_prefold``; ``None`` draws one with
    ``init_params`` from ``torch.Generator().manual_seed(seed)``. With
    ``fold_normalize`` the clip is consumed raw: patch-major ``(B, T, H/16, W/16,
    768)`` for a ``tpu_cnn`` tower, NHWC ``(B, T, H, W, 3)`` for a ViT; unfolded, it
    is NHWC and normalized on the device. A ViT backbone (any name with ``/`` or
    ``videomae``) serves with the tanh GELU, as ``__graft_entry__._build_forward`` and
    ``InferenceEngine`` serve it: the override is made on a copy of ``cfg``.
    """
    bb = cfg.model.video_backbone
    if "/" in bb or "videomae" in bb.lower():
        cfg = copy.deepcopy(cfg)
        cfg.model.gelu_approximate = True
    d = cfg.data
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    run, folded = fusion_program(cfg, params, device=device, fold_normalize=fold_normalize)

    H, W = d.video_resize
    video_example = np.zeros((batch, d.video_frames_per_window, H, W, 3), np.uint8)
    if folded and cfg.model.video_backbone.startswith("tpu_cnn"):
        video_example = to_patch_major(video_example)
    example_args = (
        torch.zeros((batch, d.imu_window_size, d.imu_channels), device=device),
        torch.from_numpy(video_example).to(device),
    )

    @torch.inference_mode()
    def forward(imu_raw: torch.Tensor, video_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw sensor counts + uint8 pixels → logits, OOD scores and embeddings."""
        logits, fused = run(imu_raw, video_u8)
        return {
            "logits": logits,
            "msp": msp_score(logits),
            "energy": energy_score(logits),
            "embeddings": fused,
        }

    return forward, example_args


def build_int8_forward(
    cfg,
    batch: int,
    *,
    device,
    seed: int = 0,
    params: Optional[Dict] = None,
    calib_clips: Optional[np.ndarray] = None,
    resident: Optional[bool] = None,
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]], Tuple]:
    """The int8 PTQ serving forward of a configuration whose tower the JAX package
    quantizes (``tpu_cnn``, ResNet-18, the ViTs), as its ``bench.py`` builds its
    headline program: returns ``(fn(imu_raw, video_u8) -> dict, example_args)`` from
    ``serving_quant.build_quantized_forward``.

    ``params`` is a flax-layout variable tree before any folding (``None`` draws one
    with ``init_params`` from ``seed``); ``calib_clips`` defaults to 2 clips of
    uint8 noise from ``np.random.default_rng(seed)``. The clip is consumed raw:
    patch-major ``(B, T, H/16, W/16, 768)`` for a ``tpu_cnn`` tower (the example is the
    uint8 wire; the returned ``fn`` takes the centered int8 wire as well, as the JAX
    package's program does), NHWC ``(B, T, H, W, 3)`` otherwise. ``resident`` picks a CNN tower's int8-resident form (``None``: the
    resident form of a CNN tower, the baseline of a ViT, which has no other; ``True``
    with a ViT raises).
    """
    from .serving_quant import _VIT_BACKBONES, build_quantized_forward

    d = cfg.data
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed))
    H, W = d.video_resize
    if calib_clips is None:
        calib_clips = (
            np.random.default_rng(seed).random((2, d.video_frames_per_window, H, W, 3)) * 255
        ).astype(np.uint8)
    if resident is None:
        resident = cfg.model.video_backbone not in _VIT_BACKBONES
    fn = build_quantized_forward(cfg, params, calib_clips, device=device, resident=resident)
    video_example = np.zeros((batch, d.video_frames_per_window, H, W, 3), np.uint8)
    if cfg.model.video_backbone.startswith("tpu_cnn"):
        video_example = to_patch_major(video_example)
    example_args = (
        torch.zeros((batch, d.imu_window_size, d.imu_channels), device=device),
        torch.from_numpy(video_example).to(device),
    )
    return fn, example_args


def entry(device="cuda"):
    """The flagship serving forward at batch 8 and its example arguments
    (``__graft_entry__.entry``): ``build_forward(flagship_config(), 8)`` on ``device``,
    its weights drawn from seed 0."""
    return build_forward(flagship_config(), 8, device=device)


def launch_counters() -> Dict[str, Callable]:
    """Each hand kernel's wrapper by name; each counts its launches in ``.launches``
    (a call on CPU tensors takes the plain version and counts none)."""
    return {
        "fused_window": featurize_windows_auto, "conv3x3_bn_act": conv3x3_bn_act,
        "conv3x3_bn_act_f32": conv3x3_bn_act_f32, "stem_gemm_u8": stem_gemm_u8,
        "conv3x3_i8": conv3x3_i8, "int8_gemm": int8_gemm, "flash_lean": flash_lean,
        "flash_bwd_dkv": flash_lean_bwd_dkv, "flash_bwd_dq": flash_lean_bwd_dq,
        "flash_lean_f32": flash_lean_f32, "flash_bwd_dkv_f32": flash_lean_bwd_dkv_f32,
        "flash_bwd_dq_f32": flash_lean_bwd_dq_f32,
    }


def _launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in launch_counters().items()}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in _launch_counts().items()}


def dryrun_config(config=None):
    """The dry run's training configuration: ``config`` (default ``flagship_config(
    tiny=True)``) in f32, as ``__graft_entry__._dryrun_one_mesh`` makes it."""
    cfg = copy.deepcopy(config) if config is not None else flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    return cfg


def dryrun_batch(cfg, batch: int) -> Dict[str, np.ndarray]:
    """The dry run's training batch of ``batch`` rows, drawn as the JAX package's is
    (``np.random.default_rng(0)``): featurized IMU ``(B, C, T)`` f32, uint8 clips,
    labels."""
    d = cfg.data
    H, W = d.video_resize
    rng = np.random.default_rng(0)
    return {
        "imu": rng.normal(size=(batch, d.imu_channels, d.imu_window_size)).astype(np.float32),
        "video": (rng.random((batch, d.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8),
        "label": rng.integers(0, cfg.model.num_classes, size=batch).astype(np.int64),
    }


def _dryrun_train(mesh, cfg, params: Optional[Dict], device) -> Dict:
    """One fully sharded fusion train step (``_dryrun_one_mesh``): the parameters and
    their AdamW moments split over the model axis, the batch of ``max(2·dp, 2)`` rows
    over the data axis. Returns its loss (the global batch's) and its batch size."""
    data = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    B = max(2 * data, 2)
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
    task = factory.build_fusion_task(cfg, 2, params, device=device, mesh=mesh)
    batch = {k: torch.from_numpy(v).to(device) for k, v in dryrun_batch(cfg, B).items()}
    gen = torch.Generator(device=device).manual_seed(0)
    _, metrics = task.train_step(task.state, batch, gen)
    loss = metrics["loss"].item()
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun_multichip: non-finite loss {loss}")
    return {"loss": loss, "batch": B}


def _dryrun_serve(mesh, device) -> Dict:
    """The bf16 and the int8 ``InferenceEngine`` of the ``tpu_cnn`` tower at the tiny
    sizes over ``mesh`` (``_dryrun_serve_impl``): ``predict`` and one round of
    ``predict_stream`` each; the int8 engine's logits against an engine without a mesh
    (``rtol = atol = 1e-5``, the same predictions). The int8 engine serves in f32, as the
    JAX package's dry run serves both engines, so that the sharded and the single program
    differ only in f32 sum order; the bf16 engine serves in bf16, its convs through the
    bf16 kernel. Returns the int8 logits' largest gap to the engine without a mesh and
    each engine's kernel launches."""
    from .serving import InferenceEngine

    cfg = flagship_config("float32", tiny=True)
    cfg.model.video_backbone = "tpu_cnn"
    d = cfg.data
    H, W = d.video_resize
    T = d.video_frames_per_window
    data = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
    B = max(2 * data, 2)
    variables = init_params(cfg, torch.Generator().manual_seed(1), FusionClassifier)
    rng = np.random.default_rng(1)
    imu = rng.normal(0, 8000.0, (B, d.imu_window_size, d.imu_channels)).astype(np.float32)
    video = (rng.random((B, T, H, W, 3)) * 255).astype(np.uint8)
    calib = (rng.random((4, T, H, W, 3)) * 255).astype(np.uint8)
    cfg_bf16 = copy.deepcopy(cfg)
    cfg_bf16.model.compute_dtype = "bfloat16"
    out = {"launches": {}}
    for name, c, kw in (("bf16", cfg_bf16, {}), ("int8", cfg, {"quantize_calib_clips": calib})):
        before = _launch_counts()
        engine = InferenceEngine(c, variables, mesh=mesh, batch_sizes=[B], device=device, **kw)
        got = engine.predict(imu, video)
        if got["logits"].shape != (B, cfg.model.num_classes):
            raise AssertionError(f"dryrun_multichip serve[{name}]: logits {got['logits'].shape}")
        for k in ("logits", "msp", "energy"):
            if not np.isfinite(got[k]).all():
                raise AssertionError(f"dryrun_multichip serve[{name}]: non-finite {k}")
        (streamed,) = list(engine.predict_stream(iter([(imu, video)])))
        np.testing.assert_allclose(streamed["logits"], got["logits"], atol=1e-5)
        if name == "int8":
            ref = InferenceEngine(c, variables, batch_sizes=[B], device=device, **kw).predict(imu, video)
            np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5, atol=1e-5)
            if not (np.asarray(got["preds"]) == np.asarray(ref["preds"])).all():
                raise AssertionError("dryrun_multichip: sharded int8 predictions diverge from one device's")
            out["int8_gap"] = float(np.abs(got["logits"] - ref["logits"]).max())
        out["launches"][name] = _launches_since(before)
        out[f"{name}_logits_shape"] = tuple(got["logits"].shape)
    return out


def _dryrun_rank(rank: int, n: int, port: int, device: str, config, params, out_dir: str) -> None:
    """Rank ``rank`` of ``dryrun_multichip``: a gloo group of ``n`` (a group of one
    where ``n`` is 1), on ``cuda:(rank % cards)`` or the CPU; the dp × tp mesh and then
    the pure-dp mesh, each a train step and the serve pass. Writes ``rank{rank}.pt``."""
    import torch.distributed as dist

    from .parallel.distributed import initialize_distributed
    from .parallel.mesh import create_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    address = f"127.0.0.1:{port}"
    if not initialize_distributed(address, n, rank, device=device, backend="gloo"):
        dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=1, rank=0)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
    try:
        model_axis = 2 if n % 2 == 0 and n > 1 else 1
        meshes = []
        for size in [model_axis] + ([1] if model_axis > 1 else []):
            mesh = create_mesh(model_axis_size=size)
            before = _launch_counts()
            train = _dryrun_train(mesh, dryrun_config(config), params, dev)
            train_launches = _launches_since(before)
            serve = _dryrun_serve(mesh, dev)
            serve["launches"]["train"] = train_launches
            meshes.append({"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), **train, **serve})
        torch.save({"rank": rank, "device": str(dev), "meshes": meshes}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, *, device="cuda", config=None, params: Optional[Dict] = None) -> List[Dict]:
    """One fully sharded (dp × tp) fusion train step and the sharded bf16 and int8
    engines on ``n_devices`` ranks (``__graft_entry__.dryrun_multichip``).

    ``n_devices`` processes are spawned on a gloo group at a free local port; on
    ``"cuda"`` rank ``k`` runs on card ``k % torch.cuda.device_count()``, so the ranks
    share the cards there are, and without a card the call raises. Each rank runs a
    ``{data: n/2, model: 2}`` mesh where ``n_devices`` is even and above 1, then the
    pure-dp ``{data: n}`` mesh: the train step of ``dryrun_config(config)`` from
    ``params`` (a ``FusionClassifier`` tree, default drawn from seed 0), whose loss must
    be finite, and the serve pass, whose sharded int8 logits must equal an engine's
    without a mesh. Prints the JAX function's ``[dryrun_multichip] ... OK`` lines and
    returns each rank's record: per mesh its shape, batch, loss, the int8 gap and the
    kernel launches of each part."""
    from .utils import resolve_device

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n_devices}")
    kind = resolve_device(device, "dryrun_multichip").type
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.start_processes(_dryrun_rank, args=(n_devices, port, kind, config, params, out),
                                              nprocs=n_devices, start_method="spawn")
        ranks = [torch.load(Path(out) / f"rank{r}.pt", weights_only=False) for r in range(n_devices)]
    for i, m in enumerate(ranks[0]["meshes"]):
        losses = {r["meshes"][i]["loss"] for r in ranks}
        if len(losses) != 1:
            raise AssertionError(f"dryrun_multichip: the ranks' losses differ on mesh {m['mesh']}: {sorted(losses)}")
        print(f"[dryrun_multichip] {n_devices} devices, mesh={m['mesh']}, train loss={m['loss']:.4f} OK")
        print(f"[dryrun_multichip] mesh={m['mesh']} int8 sharded == single-device logits (atol 1e-5, largest gap "
              f"{max(r['meshes'][i]['int8_gap'] for r in ranks):.3e}) OK")
        for name in ("bf16", "int8"):
            print(f"[dryrun_multichip] {n_devices} devices, mesh={m['mesh']}, serve[{name}] "
                  f"logits{m[f'{name}_logits_shape']} OK")
    return ranks

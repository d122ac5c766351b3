"""Serving: the batched inference engine with OOD scoring (``tpuhar/serving.py``).

``InferenceEngine`` serves the fusion classifier of a configuration (or, IMU-only, its
IMU classifier) from a flax-layout variable tree (``bridge``), the tree the JAX
package's engine takes: raw IMU counts ``(B, T, C)`` and uint8 clips ``(B, F, H, W,
3)`` in; logits, predictions, MSP and energy scores, the embedding and, where fitted,
embedding-space OOD scores and their ``is_ood_*`` flags out, as numpy arrays.

Requests are padded up to the nearest registered batch size; larger ones are chunked
through the largest. On a CUDA device each registered size is one CUDA graph
(``torch.cuda.CUDAGraph``): ``warmup`` runs the program once eagerly on a side stream
(the kernels' first use builds the library and raises their shared-memory limits, and
cuBLAS makes its handle and workspace), then captures it over static input buffers,
every size's graph in one memory pool. ``predict`` copies a request into the static
inputs, replays and reads the outputs back; ``predict_stream`` pipelines the same
with a copy stream. A capture or launch failure propagates: nothing falls back to
eager execution or to the CPU. On the CPU the program runs eagerly.
"""
from __future__ import annotations

import collections
import copy
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .bridge import load_variables
from .entry import featurize, fusion_program
from .models.crossmodal import IMUClassifier
from .ood import MahalanobisScorer, energy_score, fit_ood_thresholds, msp_score
from .ops.conv3x3 import conv3x3_bn_act, conv3x3_i8
from .ops.flash_lean import flash_lean
from .ops.fused_window import featurize_windows_auto
from .ops.stem import int8_gemm, stem_gemm_u8, to_patch_major
from .utils import resolve_device
from .utils.profiling import StepProfiler

PATCH = 16  # the tpu_cnn stem's patch: the patch-major wire is (..., H/16, W/16, 768)
# the hand kernels a serving program launches; each wrapper counts its launches
KERNEL_COUNTERS = {
    "fused_window": featurize_windows_auto,
    "conv3x3_bn_act": conv3x3_bn_act,
    "stem_gemm_u8": stem_gemm_u8,
    "conv3x3_i8": conv3x3_i8,
    "int8_gemm": int8_gemm,
    "flash_lean": flash_lean,
}


def kernel_launches() -> Dict[str, int]:
    """Each serving kernel's launch count so far."""
    return {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}


@dataclass
class _Graph:
    """One registered batch size on the card: its graph, the static inputs each request
    is copied into, the static outputs each replay overwrites, and pinned host buffers
    they are read back into."""

    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    outputs: Dict[str, torch.Tensor]
    host: Dict[str, torch.Tensor]


class InferenceEngine:
    """Batched fused inference over the fusion model (or IMU-only), on ``device``.

    ``predict(imu_raw, video_u8)`` takes raw counts ``(B, T, C)`` and uint8 pixels
    ``(B, F, H, W, 3)``; IMU-only engines take just ``imu_raw``. It returns ``logits``,
    ``preds`` (int32), ``msp``, ``energy``, ``embeddings`` and the fitted scorers'
    scores (f32), and ``is_ood_{score}`` (bool) once thresholds are set.

    **Featurization scope**, as in the reference: the engine z-scores per *window* (only
    the window exists at serving time), the offline preprocessor's default per
    *sequence*. Train with ``data.zscore_scope="window"`` for train == serve, or at
    least refit the embedding scorers on served embeddings (``fit_embedding_scorers``).

    The constructor takes the reference's arguments (``quantize_calib_clips`` and
    friends for the int8 towers, ``extra_scorers``, ``temperature`` dividing the logits
    before MSP and energy, ``fast_gelu``/``fast_attention`` for ViT towers; see
    ``tpuhar/serving.py``) and ``device``. An int8 engine serves every tower the JAX
    package quantizes (``serving_quant``): ``tpu_cnn`` on the patch-major wire, ResNet-18
    and the ViTs on NHWC clips; ``quantized_forward`` is its ``build_quantized_forward``
    program. Not ported: ``mesh`` (ROADMAP queue 1 item 8) and the centered int8 wire.
    """

    def __init__(
        self,
        config,
        variables: Dict,
        *,
        imu_only: bool = False,
        batch_sizes: Optional[List[int]] = None,
        mesh=None,
        mahalanobis: Optional[MahalanobisScorer] = None,
        extra_scorers: Optional[Dict] = None,
        temperature: float = 1.0,
        fold_normalize: bool = True,
        quantize_calib_clips=None,
        quantize_calib_imu=None,
        quantize_resident: bool = False,
        verify_byte_map: bool = False,
        int8_wire: str = "u8",
        fast_gelu: bool = True,
        fast_attention: bool = False,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded engine is not ported: ROADMAP queue 1 item 8 (parallel/mesh.py)"
            )
        if quantize_calib_clips is not None and imu_only:
            raise ValueError(
                "quantize_calib_clips requests the int8 video tower, which does not "
                "exist for imu_only=True — drop one of the two options"
            )
        if quantize_calib_imu is not None and quantize_calib_clips is None:
            raise ValueError(
                "quantize_calib_imu only pairs with quantize_calib_clips (it feeds "
                "the int8 logit-recalibration fit)"
            )
        self.quantized = quantize_calib_clips is not None
        if self.quantized and int8_wire not in ("u8", "centered"):
            raise ValueError(f"int8_wire must be 'u8' or 'centered', got {int8_wire!r}")
        if self.quantized and int8_wire == "centered":
            raise NotImplementedError(
                "the centered int8 wire is not ported (ROADMAP.md, 'Not ported'); serve int8_wire='u8'"
            )
        self.device = resolve_device(device, "InferenceEngine")
        # the constructor's inputs, for fit_embedding_scorers' rebuild
        self._ctor = dict(
            config=config, variables=variables, imu_only=imu_only, batch_sizes=batch_sizes,
            temperature=temperature, fold_normalize=fold_normalize,
            quantize_calib_clips=quantize_calib_clips, quantize_calib_imu=quantize_calib_imu,
            quantize_resident=quantize_resident, verify_byte_map=verify_byte_map,
            int8_wire=int8_wire, fast_gelu=fast_gelu, fast_attention=fast_attention, device=device,
        )
        # the ViT serving overrides, made on a copy of the config: the tanh GELU, and
        # with fast_attention the flash kernel (the port reads neither flash_kernel nor
        # the block sizes; one Hopper kernel serves both of the reference's)
        bb = config.model.video_backbone
        is_vit = "/" in bb or "videomae" in bb.lower()
        if (fast_gelu or fast_attention) and not imu_only and is_vit:
            config = copy.deepcopy(config)
            if fast_gelu:
                config.model.gelu_approximate = True
            if fast_attention:
                config.model.use_flash_attention = True
                config.model.flash_kernel = "lean"
        self.config = config
        self.imu_only = imu_only
        self.batch_sizes = sorted(batch_sizes or [256])
        self.mahalanobis = None if mahalanobis is None else mahalanobis.to(self.device)
        self.extra_scorers = {name: s.to(self.device) for name, s in (extra_scorers or {}).items()}
        self.temperature = float(temperature)
        # divided by as a 0-d device tensor: on CUDA PyTorch turns a division by a host
        # scalar into a product with its reciprocal, which rounds differently
        self._temperature = torch.tensor(self.temperature, device=self.device)
        self.profiler = StepProfiler()
        # {score_name: threshold} from calibrate_ood_thresholds(); when set, predict
        # and predict_stream add boolean ``is_ood_{name}`` outputs.
        self.ood_thresholds: Optional[Dict[str, float]] = None
        self.folded = False
        self._graphs: Dict[int, _Graph] = {}
        self._pool = None
        # launches of each serving kernel in each size's graph: the count per replay
        self.graph_launches: Dict[int, Dict[str, int]] = {}

        if self.quantized:
            from .serving_quant import build_quantized_forward

            qforward = build_quantized_forward(
                config, variables, np.asarray(quantize_calib_clips), device=self.device,
                calib_imu_raw=None if quantize_calib_imu is None else np.asarray(quantize_calib_imu),
                resident=quantize_resident,
            )
            self._program = qforward.core
            self.quantized_forward = qforward
            # a tpu_cnn int8 tree folds the ImageNet affine into a stem that reads raw
            # uint8 patch-major pixels, the device fusing the u8 byte map into the stem
            # GEMM; ResNet-18 and the ViTs take the NHWC clip
            self.patch_major = bb.startswith("tpu_cnn")
            if verify_byte_map and self.patch_major:
                from .ops.stem import verify_byte_map as _verify

                _verify(self.device)
        elif imu_only:
            dtype = getattr(torch, config.model.compute_dtype)
            model = load_variables(IMUClassifier(config, dtype=dtype), variables).to(self.device).eval()
            self._program = lambda imu_raw: model(featurize(config, imu_raw))
            self.patch_major = False
        else:
            # the ImageNet affine folded into the stem (one less pass): the folded
            # tpu_cnn stem reads the clip patch-major, as one K=768 GEMM
            self._program, self.folded = fusion_program(
                config, variables, device=self.device, fold_normalize=fold_normalize
            )
            self.patch_major = self.folded and bb.startswith("tpu_cnn")

    @classmethod
    def from_checkpoint(cls, config, checkpoint_path, *, imu_only: bool = False, device="cuda", **kw):
        """An engine on ``device`` serving the model of a training checkpoint
        (``train/checkpoint``, as ``ClassificationTrainer`` writes it): a finetune IMU
        classification task (``imu_only``) or a fusion task is built on the host, the
        checkpoint's parameters and buffers are restored into it (a linear probe's
        checkpoint included) and its variables served."""
        from .bridge import init_params, variables_to_numpy
        from .models.crossmodal import FusionClassifier
        from .train import checkpoint as ckpt
        from .train.factory import build_classification_task, build_fusion_task

        resolve_device(device, "InferenceEngine")  # refuse a missing card before building anything
        model_cls = IMUClassifier if imu_only else FusionClassifier
        params = init_params(config, torch.Generator().manual_seed(0), model_cls)
        if imu_only:
            task = build_classification_task(config, "finetune", 1, params, device="cpu")
        else:
            task = build_fusion_task(config, 1, params, device="cpu")
        ckpt.restore_checkpoint(checkpoint_path, task.state, model_only=True)
        return cls(config, variables_to_numpy(task.model), imu_only=imu_only, device=device, **kw)

    @torch.inference_mode()
    def _forward(self, *args) -> Dict[str, torch.Tensor]:
        """The served program: the model, then the OOD scores (the argmax-preserving
        calibration temperature divides the logits before MSP and energy)."""
        logits, emb = self._program(*args)
        scaled = logits / self._temperature if self.temperature != 1.0 else logits
        out = {
            "logits": logits,
            "preds": torch.argmax(logits, dim=-1).to(torch.int32),
            "msp": msp_score(scaled),
            "energy": energy_score(scaled, self.config.ood.energy_temperature),
            "embeddings": emb.float(),
        }
        if self.mahalanobis is not None:
            out["mahalanobis"] = self.mahalanobis.score(emb)
        for name, scorer in self.extra_scorers.items():
            out[name] = scorer.score(emb)
        return out

    def _padded_size(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def _prep_video(self, video_u8):
        """Host-side layout shuffle to the serving patch-major layout (no-op for
        engines whose towers consume NHWC, or if the caller pre-converted)."""
        if video_u8 is None or not self.patch_major:
            return video_u8
        if video_u8.shape[-1] != 3:  # already patch-major
            return video_u8
        return to_patch_major(np.asarray(video_u8))

    def _pad_to(self, imu_raw, video_u8, b: int) -> Tuple[np.ndarray, ...]:
        """The request as the program's contiguous host arrays, padded with zeros to
        ``b`` rows: f32 counts and, unless IMU-only, the clip in the serving layout."""
        imu_raw = np.asarray(imu_raw, np.float32)
        video_u8 = None if self.imu_only else self._prep_video(video_u8)
        n = imu_raw.shape[0]
        if n < b:
            pad = ((0, b - n),) + ((0, 0),) * (imu_raw.ndim - 1)
            imu_raw = np.pad(imu_raw, pad)
            if video_u8 is not None:
                vpad = ((0, b - n),) + ((0, 0),) * (video_u8.ndim - 1)
                video_u8 = np.pad(video_u8, vpad)
        if self.imu_only:
            return (np.ascontiguousarray(imu_raw),)
        return np.ascontiguousarray(imu_raw), np.ascontiguousarray(video_u8)

    def _input_specs(self, b: int) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """Shape and dtype of each of the program's inputs at batch ``b``."""
        d = self.config.data
        specs = [((b, d.imu_window_size, d.imu_channels), torch.float32)]
        if not self.imu_only:
            H, W = d.video_resize
            F = d.video_frames_per_window
            shape = (b, F, H // PATCH, W // PATCH, PATCH * PATCH * 3) if self.patch_major else (b, F, H, W, 3)
            specs.append((shape, torch.uint8))
        return specs

    def warmup(self) -> None:
        """On CUDA, capture one graph per registered batch size (each after an eager
        call on a side stream), all in one memory pool; on the CPU, run each size once
        eagerly. Capture errors propagate."""
        for b in self.batch_sizes:
            if self.device.type == "cpu":
                self._forward(*(torch.zeros(shape, dtype=dtype) for shape, dtype in self._input_specs(b)))
            elif b not in self._graphs:
                self._graphs[b] = self._capture(b)

    def _capture(self, b: int) -> _Graph:
        with torch.inference_mode(), torch.cuda.device(self.device):
            inputs = tuple(
                torch.zeros(shape, dtype=dtype, device=self.device) for shape, dtype in self._input_specs(b)
            )
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._forward(*inputs)
            torch.cuda.current_stream().wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            before = kernel_launches()
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = self._forward(*inputs)
            self.graph_launches[b] = {k: n - before[k] for k, n in kernel_launches().items()}
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in outputs.items()}
        return _Graph(graph, inputs, outputs, host)

    def _graph(self, b: int) -> _Graph:
        if b not in self._graphs:
            self.warmup()
        return self._graphs[b]

    def _upload(self, b: int, args) -> None:
        """Copy a padded request (``_pad_to``) into size ``b``'s static inputs, from
        pageable host memory."""
        g = self._graph(b)
        with torch.inference_mode():
            for dst, src in zip(g.inputs, args):
                dst.copy_(torch.from_numpy(src))

    def _replay(self, b: int) -> None:
        self._graphs[b].graph.replay()

    def _readback(self, b: int) -> Dict[str, np.ndarray]:
        """Size ``b``'s outputs on the host, after the replay ends."""
        g = self._graphs[b]
        with torch.inference_mode():
            for k, v in g.outputs.items():
                g.host[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return {k: v.numpy().copy() for k, v in g.host.items()}

    def _run(self, b: int, args) -> Dict[str, np.ndarray]:
        """The padded request ``args`` through size ``b``'s program, on the host."""
        if self.device.type == "cpu":
            return {k: v.numpy() for k, v in self._forward(*(torch.from_numpy(a) for a in args)).items()}
        self._upload(b, args)
        self._replay(b)
        return self._readback(b)

    def calibrate_ood_thresholds(self, imu_raw, video_u8=None, *, id_fpr: float = 0.05) -> Dict[str, float]:
        """Fit per-score OOD decision thresholds on ID calibration inputs served
        through THIS engine's program: the ``1 - id_fpr`` ID quantile of each score
        (``ood.fit_ood_thresholds``). Afterwards ``predict``/``predict_stream`` emit
        boolean ``is_ood_{score}`` columns beside the raw scores."""
        out = self.predict(np.asarray(imu_raw), video_u8)
        self.ood_thresholds = fit_ood_thresholds(
            {name: out[name] for name in self._ood_score_names(out)}, id_fpr=id_fpr
        )
        return dict(self.ood_thresholds)

    def fit_embedding_scorers(
        self,
        imu_raw,
        video_u8=None,
        labels=None,
        *,
        scores=("mahalanobis",),
        knn_k: int = 10,
    ) -> "InferenceEngine":
        """Fit embedding-space OOD scorers (``scores`` ⊆ {"mahalanobis", "knn",
        "rmd"}; ``labels`` needed for mahalanobis/rmd) on ID calibration data served
        through THIS engine's program, and return a NEW engine with them installed.

        As in the reference, the new engine is built from the constructor's config,
        variables, sizes, temperature, folding, calibration inputs and device only:
        ``quantize_resident``, ``verify_byte_map``, ``int8_wire``, ``fast_gelu`` and
        ``fast_attention`` take their defaults. So a refit int8-resident engine serves
        the baseline int8 tower, and a refit ``fast_attention=True`` ViT engine serves
        without flash attention (ROADMAP §3)."""
        from .ood import KNNScorer, RelativeMahalanobisScorer

        unknown = set(scores) - {"mahalanobis", "knn", "rmd"}
        if unknown:
            raise ValueError(f"Unknown embedding scorers {sorted(unknown)}")
        needs_labels = {"mahalanobis", "rmd"} & set(scores)
        if needs_labels and labels is None:
            raise ValueError(f"labels required to fit {sorted(needs_labels)}")

        emb = self.predict(np.asarray(imu_raw), video_u8)["embeddings"]
        num_classes = self.config.model.num_classes
        maha = None
        if "mahalanobis" in scores:
            maha = MahalanobisScorer.fit(emb, np.asarray(labels), num_classes)
        extras = {}
        if "knn" in scores:
            extras["knn"] = KNNScorer.fit(emb, k=knn_k)
        if "rmd" in scores:
            extras["rmd"] = RelativeMahalanobisScorer.fit(emb, np.asarray(labels), num_classes)
        c = self._ctor
        return InferenceEngine(
            c["config"], c["variables"], imu_only=c["imu_only"], batch_sizes=c["batch_sizes"],
            mahalanobis=maha, extra_scorers=extras, temperature=c["temperature"],
            fold_normalize=c["fold_normalize"], quantize_calib_clips=c["quantize_calib_clips"],
            quantize_calib_imu=c["quantize_calib_imu"], device=c["device"],
        )

    def _ood_score_names(self, out: Dict) -> List[str]:
        fixed = [k for k in ("msp", "energy", "mahalanobis") if k in out]
        return fixed + [k for k in self.extra_scorers if k in out]

    def _flag_ood(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.ood_thresholds:
            for name, thr in self.ood_thresholds.items():
                if name in out:
                    out[f"is_ood_{name}"] = np.asarray(out[name]) >= thr
        return out

    def predict(self, imu_raw, video_u8=None) -> Dict[str, np.ndarray]:
        n = imu_raw.shape[0]
        b = self._padded_size(n)
        if n > b:
            # chunk oversized requests through the largest program
            outs = [
                self.predict(imu_raw[i : i + b], None if video_u8 is None else video_u8[i : i + b])
                for i in range(0, n, b)
            ]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        self.profiler.start()
        out = self._run(b, self._pad_to(imu_raw, video_u8, b))
        self.profiler.stop()
        return self._flag_ood({k: v[:n] for k, v in out.items()})

    def _batch_arrays(self, batch):
        """``(imu, video)`` of a stream batch: a tuple, ``imu_raw`` alone (IMU-only),
        or a dict with ``imu``/``imu_raw`` and ``video`` keys."""
        if isinstance(batch, dict):
            imu = np.asarray(batch["imu_raw" if "imu_raw" in batch else "imu"])
            video = None if self.imu_only else np.asarray(batch["video"])
        elif isinstance(batch, tuple):
            imu, video = (batch[0], None) if self.imu_only else batch
        else:
            imu, video = batch, None
        return imu, video

    def predict_stream(self, batches, *, depth: int = 2):
        """Serve an iterable of batches with upload, compute and readback overlapped;
        yields one host-side output dict per input batch, in order.

        ``batches`` yields ``(imu_raw, video_u8)`` tuples (``imu_raw`` alone for
        IMU-only engines, or dicts with ``imu``/``video`` keys). A batch larger than
        the largest registered size raises (``predict`` chunks; the stream keeps one
        output per batch). One background thread pads batch N+depth on the host and,
        on CUDA, uploads it through pinned buffers on a copy stream while batch N
        replays; events order copy, replay and readback (``_StreamStaging``). On the
        CPU the program runs on the calling thread while the next batch is padded.
        """
        depth = max(int(depth), 1)
        staging = None
        if self.device.type == "cuda":
            # every graph is captured before the upload thread starts: no other work
            # may reach the card while a capture is open
            if len(self._graphs) < len(self.batch_sizes):
                self.warmup()
            staging = _StreamStaging(self, depth)

        def upload(batch):
            imu, video = self._batch_arrays(batch)
            n = imu.shape[0]
            if n > self.batch_sizes[-1]:
                raise ValueError(
                    f"stream batch of {n} exceeds the largest registered batch size "
                    f"({self.batch_sizes[-1]}); stream-chunk upstream or register a larger "
                    "batch size (predict() chunks, predict_stream keeps 1:1 batch correspondence)"
                )
            b = self._padded_size(n)
            args = self._pad_to(imu, video, b)
            if staging is None:
                return b, n, tuple(torch.from_numpy(a) for a in args)
            return b, n, staging.upload(b, args)

        def launch(b, staged):
            if staging is None:
                return {k: v.numpy() for k, v in self._forward(*staged).items()}
            return staging.launch(b, staged)

        try:
            with ThreadPoolExecutor(max_workers=1) as pool:
                uploads = collections.deque()  # upload futures, FIFO
                inflight = collections.deque()  # (launched batch, n), FIFO
                it = iter(batches)
                exhausted = False
                while True:
                    # keep the upload thread `depth` batches ahead
                    while not exhausted and len(uploads) + len(inflight) < depth + 1:
                        try:
                            uploads.append(pool.submit(upload, next(it)))
                        except StopIteration:
                            exhausted = True
                    # launch every finished upload (replays are enqueued, not waited for)
                    while uploads and (uploads[0].done() or not inflight):
                        b, n, staged = uploads.popleft().result()
                        inflight.append((launch(b, staged), n))
                    if not inflight:
                        if exhausted and not uploads:
                            return
                        continue
                    launched, n = inflight.popleft()
                    out = launched if staging is None else staging.collect(launched)
                    yield self._flag_ood({k: v[:n] for k, v in out.items()})
        finally:
            if staging is not None:  # nothing in flight may outlive the staging buffers
                torch.cuda.synchronize(self.device)

    def latency_summary(self) -> Dict[str, float]:
        return self.profiler.summary()


class _Slot:
    """One staged batch of ``predict_stream``: pinned host and device copies of the
    program's inputs, pinned host outputs, and the events that end its upload and its
    readback."""

    def __init__(self, g: _Graph):
        self.host_in = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in g.inputs]
        self.dev_in = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in g.inputs]
        self.host_out = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in g.outputs.items()}
        self.uploaded = torch.cuda.Event()
        self.done = torch.cuda.Event()


class _StreamStaging:
    """``predict_stream``'s buffers on the card: per batch size a ring of ``depth + 1``
    slots, used in turn. At most ``depth + 1`` batches are between their upload and
    their readback, so a slot comes round again only after its last batch was read back.

    - ``upload`` (the upload thread): the padded arrays into the slot's pinned
      buffers, then to its device buffers on the copy stream; ``uploaded`` recorded.
    - ``launch`` (the calling thread): the compute stream waits for ``uploaded``,
      copies the slot into the graph's static inputs, replays, and copies the static
      outputs into the slot's pinned outputs before a later replay can overwrite them;
      ``done`` recorded.
    - ``collect``: waits for ``done`` and copies the outputs out of the slot.
    """

    def __init__(self, engine: InferenceEngine, depth: int):
        self.engine = engine
        self.slots = depth + 1
        self.copy_stream = torch.cuda.Stream(engine.device)
        self.rings: Dict[int, List[_Slot]] = {}
        self.uploads = collections.Counter()  # per size; only the upload thread counts

    def upload(self, b: int, args) -> _Slot:
        ring = self.rings.setdefault(b, [])
        i = self.uploads[b] % self.slots
        self.uploads[b] += 1
        if i == len(ring):
            ring.append(_Slot(self.engine._graphs[b]))
        slot = ring[i]
        for dst, src in zip(slot.host_in, args):
            np.copyto(dst.numpy(), src)
        with torch.cuda.stream(self.copy_stream):
            for dst, src in zip(slot.dev_in, slot.host_in):
                dst.copy_(src, non_blocking=True)
            slot.uploaded.record(self.copy_stream)
        return slot

    def launch(self, b: int, slot: _Slot) -> _Slot:
        g = self.engine._graphs[b]
        stream = torch.cuda.current_stream(self.engine.device)
        stream.wait_event(slot.uploaded)
        with torch.inference_mode():
            for dst, src in zip(g.inputs, slot.dev_in):
                dst.copy_(src)
            g.graph.replay()
            for k, v in g.outputs.items():
                slot.host_out[k].copy_(v, non_blocking=True)
        slot.done.record(stream)
        return slot

    @staticmethod
    def collect(slot: _Slot) -> Dict[str, np.ndarray]:
        slot.done.synchronize()
        return {k: v.numpy().copy() for k, v in slot.host_out.items()}


def benchmark_engine(engine: InferenceEngine, batch: int, iters: int = 20) -> Dict:
    """Steady-state throughput/latency of an engine at one batch size."""
    d = engine.config.data
    H, W = d.video_resize
    rng = np.random.default_rng(0)
    imu = rng.normal(0, 8000, size=(batch, d.imu_window_size, d.imu_channels)).astype(np.float32)
    video = None
    if not engine.imu_only:
        video = (rng.random((batch, d.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
    engine.predict(imu, video)  # warm up
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.predict(imu, video)
    dt = time.perf_counter() - t0
    return {
        "throughput": batch * iters / dt,
        "step_ms": dt / iters * 1e3,
        **{f"lat_{k}": v for k, v in engine.latency_summary().items()},
    }

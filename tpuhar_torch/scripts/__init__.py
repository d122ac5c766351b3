"""The repo's validation workflows on the port: one module per script of the JAX
package's ``scripts/`` that produces its accuracy and OOD evidence, with the same file
name, arguments and output JSON, run as ``python -m tpuhar_torch.scripts.<name>``.

- ``bench_accuracy``: the matched-budget head-to-head of the towers as fusion
  classifiers, with leave-one-out OOD AUROC; writes the checkpoints the next two read.
- ``validate_int8_ood``: f32 against int8 OOD-AUROC on those leave-one-out checkpoints.
- ``rescore_ood_hard``: every OOD scorer, and temperature calibration, on them.
- ``article_workflow``: pretrain → probe and finetune → few-shot, with a from-scratch
  control arm.
- ``validate_pretraining``: a probe on a pretrained IMU encoder against one on a random
  encoder.
- ``graft_weights``: a torch/npz checkpoint grafted into the port's model, as a ``.pt``.

The research probes and debug scripts, which take the JAX scripts' positional
arguments (``python -m tpuhar_torch.scripts.<name> [args] [--cpu]``) and have a
``run(...)`` whose keywords hold the JAX scripts' constants:

- ``measure_resident_drift [n_seeds]``: the resident-against-baseline int8 ResNet-18
  logit drift over seeds.
- ``debug_ckpt_data_match [root] [tower] [n]``: a stored fusion checkpoint scored on
  the windows now on disk, beside its training-time last epoch.
- ``debug_pretrain_parity [steps] [workdir]``: the pretraining step on the CPU and on the
  card at each matmul precision, from one initial state over the same batches.
- ``debug_pretrain_loop [workdir]``: ``Pipeline.run_pretraining`` with a loss line a batch.
- ``probe_pretrain_collapse [epochs]``: the IMU embedding's collapse and a linear probe,
  per pretraining learning rate.
- ``probe_imu_hard_lr [epochs]``: the IMU finetune per learning rate.
- ``probe_coupling_strength``: pair retrieval per cross-modal coupling strength and loss.

The timing and decomposition scripts, likewise (``run(...)`` returns the dict each
prints, its keywords the JAX script's constants), each timing with
``profile_step.median_ms`` and setting times against ``utils/roofline``'s floors:

- ``bench_train [batch]``: the pretraining and fusion finetune train steps.
- ``bench_preprocess``: the preprocessor's host scipy chain against its device route.
- ``bench_loader [--workers=N]``: ``BatchLoader``'s IMU and clip rates.
- ``bench_serving_stream [--int8] [--quick]``: a host-fed stream through
  ``predict_stream``, and which of the host, the upload and the card bounds it.
- ``perf_decompose [batch]``, ``perf_nonvideo [batch]``, ``perf_quant [batch]``: the
  flagship step by part, outside the tower, and bf16 against int8-resident.
- ``perf_int8_stages [frames]``, ``perf_vit_stages [batch]``: the int8 tower's stages
  and the ViT's units against their floors.
- ``perf_sweep [backbone:batch ...]``, ``perf_tpucnn_variants [w0,w1 ...]``: tower and
  width sweeps of the serving forward.
- ``perf_trace [backbone]``: a profiler trace of the flagship step and its top ops.
- ``generate_tables [--results-dir] [--demo]``: the article tables (host only).

Each runs on the card unless ``--cpu`` is given (``graft_weights`` moves no tensor to a
device), and raises without a card. Outputs default under ``outputs/torch/``: where a
JAX script writes ``outputs/X`` the port writes ``outputs/torch/X``, and ``docs/X``
becomes ``outputs/torch/docs/X``. Checkpoints are the port's ``.pt``
(``train/checkpoint``). ``--quick`` shrinks a run; unlike the JAX scripts' it does not
pick the CPU.
"""

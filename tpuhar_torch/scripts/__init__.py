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

Each runs on the card unless ``--cpu`` is given (``graft_weights`` moves no tensor to a
device). Outputs default under ``outputs/torch/``: where a JAX script writes
``outputs/X`` the port writes ``outputs/torch/X``, and ``docs/X`` becomes
``outputs/torch/docs/X``. Checkpoints are the port's ``.pt`` (``train/checkpoint``).
``--quick`` shrinks a run; unlike the JAX scripts' it does not pick the CPU.
"""

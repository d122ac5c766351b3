"""tpuhar_torch — the PyTorch/CUDA port of ``tpuhar`` for NVIDIA Hopper (H100).

Serving slices (``entry``): the flagship bf16 IMU+video fusion forward
(``build_forward(flagship_config())``), its int8-resident form
(``build_int8_forward``) and the ``videomae_base`` ViT forward
(``build_forward(vit_config())``), all three served by ``serving.InferenceEngine`` (one
CUDA graph per registered batch size, padding, chunking, a pipelined stream, OOD
scorers and thresholds, IMU-only serving). Training slice (``entry``, ``train``, ``losses``):
the cross-modal SigLIP pretraining of the ``videomae_base`` model
(``build_pretrain_task(pretrain_config())``), the classifiers, and the evaluate stage
(``eval``, ``ood.OODEvaluator``) over the data loaders (``data``), with pretrained video
backbones converted and grafted (``models.convert``). The pipeline (``cli``, run as
``python -m tpuhar_torch``) takes the raw dataset through preprocessing
(``data.preprocess``), every stage and serving, with its reports (``report``). Plain tensor code is PyTorch; the kernels
on these paths are written by hand for ``sm_90a`` in ``csrc/`` (the fused window
featurizer, the fused 3x3 conv in bf16 and int8, the uint8 stem GEMM, flash attention
and its dK/dV and dQ backward), each with its plain PyTorch version beside it. Module names mirror ``tpuhar/``. The port imports
no JAX and nothing of the JAX package: ``config`` is its own copy of the configuration.
"""

__version__ = "0.1.0"

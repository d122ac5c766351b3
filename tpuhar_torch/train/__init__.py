"""Training of the port (``tpuhar/train``): optimizer and schedule, steps, checkpoints,
the epoch loop and the task factory. Cross-modal pretraining only so far."""

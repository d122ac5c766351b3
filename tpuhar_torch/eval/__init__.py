"""Evaluation of the port (``tpuhar.eval`` counterparts): ``metrics.auroc``."""

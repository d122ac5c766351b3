"""Kernels and plain tensor ops of the port (``tpuhar.ops`` counterparts)."""

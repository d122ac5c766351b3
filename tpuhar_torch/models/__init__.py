"""Models of the port (``tpuhar.models`` counterparts)."""

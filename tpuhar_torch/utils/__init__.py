"""Host-side utilities of the port (``tpuhar.utils`` counterparts): the serving
engine's rolling latency profile (``profiling.StepProfiler``) and the trainers' metric
stream (``profiling.MetricsLogger``)."""

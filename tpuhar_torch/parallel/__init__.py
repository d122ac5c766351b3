"""Data-parallel training and serving over a process group (``tpuhar/parallel/``):
``distributed`` starts the group, ``mesh`` builds the ``("data", "model")`` device mesh
and places batches and state on it, ``scope`` holds the collectives that make a step on
this rank's rows compute the one-device step on the global batch."""

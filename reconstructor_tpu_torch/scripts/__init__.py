"""Profiling entry points of the port: ``profile_knn_kernel`` (the kNN
kernel's cost split by level), ``check_packed`` (the packed kNN kernel
against the float one) and ``profile_incremental`` (per-stage wall, launch
and device-busy time of the incremental loop). Each runs on the card
unless given ``--device cpu``."""

"""Entry points of the port beside the CLI: profiling (``profile_knn_kernel``,
``check_packed``, ``profile_incremental``, ``profile_ba``,
``profile_ba_latency``, ``exp_ba``), the stress run (``stress_synth``,
``stress_report``), the multi-process runs (``run_multiproc_dryrun``,
``bench_scaling``, ``diag_scaling``), SuperPoint training
(``train_frontend``) and the BA precision variants
(``check_ba_variants``). Those that use a device run on the card unless
given ``--device cpu``."""

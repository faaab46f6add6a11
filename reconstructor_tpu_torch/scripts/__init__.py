"""Entry points of the port beside the CLI: profiling (``profile_knn_kernel``,
``check_packed``, ``profile_incremental``, ``profile_ba``,
``profile_ba_latency``, ``profile_pcg_path``, ``exp_ba``), the stress run
(``stress_synth``, ``stress_report``), the multi-process runs (``run_multiproc_dryrun``,
``bench_scaling``, ``diag_scaling``), the learned front end's trainers
(``train_frontend``; ``distill_fountain`` and ``train_superglue``, whose
``main()`` reads the fountain photographs) and the BA precision variants
(``check_ba_variants``). Those that use a device run on the card unless
given ``--device cpu`` (the two photograph trainers: ``--cpu``, their JAX
scripts' flag)."""

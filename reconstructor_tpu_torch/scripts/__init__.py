"""Entry points of the port beside the CLI: profiling (``profile_knn_kernel``,
``check_packed``, ``profile_incremental``, ``profile_ba``,
``profile_ba_latency``, ``profile_pcg_path``, ``exp_ba``), the stress run
(``stress_synth``, ``stress_report``), the multi-process runs (``run_multiproc_dryrun``,
``bench_scaling``, ``diag_scaling``), the learned front end's trainers
(``train_frontend``; ``distill_fountain`` and ``train_superglue``, whose
``main()`` reads the fountain photographs) and the BA precision variants
(``check_ba_variants``), and the six scripts that measure on the fountain
photographs (``measure_match100``, ``bench_knn_dtype``,
``profile_match100_decomp``, ``exp_match_regression``, ``profile_detect``,
``exp_quality``). Those that use a device run on the card unless given
``--device cpu`` (the two photograph trainers: ``--cpu``, their JAX
scripts' flag).

The photograph scripts' ``main()`` reads ``reference/data`` inside the
repository and stops with a message naming it until the photographs are
committed there; their functions take images or a feature state, and run
on the CPU in the tests (``tests/test_torch_{distill,train_superglue,
measure_match,profile_detect,exp_quality}.py``) and on the card through
``chip_smoke.py``'s distill, train-superglue and measure phases, on the
rendered scene."""

"""The reference's experiment scripts on the port: twins of the JAX
package's ``scripts/`` (and of ``run_longctx_grid.sh``,
``run_dynamic_sweep.sh`` and ``archive_grid_results.sh``, which become
Python here), run as ``python -m vattention_tpu_torch.scripts.<name>``.

- ``benchmark_e2e_static_trace``: makespan over model x backend x
  context x P:D;
- ``benchmark_e2e_dynamic_trace``: normalized e2e latency under Poisson
  arrivals (``--sweep``: ``run_dynamic_sweep.sh``'s settings);
- ``longctx_grid``: ``run_longctx_grid.sh``'s cells, one process each;
- ``collect_longctx_grid``: the grid's ``grid_results.json``, the stall
  audit, the vs_paged ratios (``--archive``: ``archive_grid_results.sh``);
- ``process_e2e_static``, ``process_e2e_dynamic``,
  ``render_perf_tables``: the tables (``--plot``: matplotlib, where it is
  installed);
- ``run_capacity_search``: the QPS capacity under a scheduling-delay SLO;
- ``profile_backend_step``, ``profile_decode_step``: step times of the
  prefill and the steady decode, and of the captured decode step alone;
- ``measure_pp_step``: pp = 1 against pp = 2 per-step time.

Every module takes ``--device`` (``cuda``, the default, or ``cpu``) and
raises without a GPU unless given ``--device cpu``.  Outputs go under
``benchmark_output/``.  Importing a module here does nothing.
"""

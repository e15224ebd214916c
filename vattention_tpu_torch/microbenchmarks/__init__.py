"""Kernel-level A/B harnesses of the port, twins of the JAX package's
``scripts/artifact/run_kernel_sweep.py``,
``microbenchmarks/perf_pagesize/bench_pagesize.py``,
``microbenchmarks/bench_pod.py``, ``scripts/probe_pod_depth.py`` and
``microbenchmarks/bench_decode_kernel.py``.

Each runs on the card (``python -m vattention_tpu_torch.microbenchmarks.
<name>``), or on the CPU with ``--cpu`` (``bench_decode_kernel``: ``--device
cpu``; the kernels' plain versions at tiny shapes, host times).  Importing
a module here does nothing.
"""

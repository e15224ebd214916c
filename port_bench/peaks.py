"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, no sparsity.

Copied from ``vattention_tpu_torch/microbenchmarks/timing.py`` (its
``PEAK_BF16_FLOPS`` and ``PEAK_BYTES_PER_S``), so that the yardstick does
not move with the program.  The rates assume the card's full 700 W power
limit; every run prints the limit it ran under.
"""

BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3 bytes/s

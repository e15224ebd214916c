"""Mistral is the Llama forward with a sliding window (``sliding_window``
in the configuration), which ``llama.Reference`` applies."""

from port_bench.reference.llama import Reference  # noqa: F401

"""Mistral's weights are the Llama family's, in the same program layout."""

from port_bench.families.llama import (  # noqa: F401
    PROGRAM, load_into_program, shapes)

"""Attention backend registry.

ref: sarathi-lean/sarathi/model_executor/attention/__init__.py:36-201.
The reference exposes 16 backend values spanning {FlashAttention,
FlashInfer} x {paged, vattn-contiguous, megacache, POD-fused, streams}.
The port maps them onto its CUDA kernels:

  *_VATTN*, FI_UNPAGED, FA_STREAMS*
                  -> the contiguous arena (vattn_backend.py): kernel B
                     (ops/flash_prefill) and kernel C (ops/flash_decode)
                     over host-resolved row tables.  The streams names are
                     a serial alias of the vattn path, as in the JAX
                     package (docs/PARITY.md P10).
  *_PAGED         -> the paged pool (paged_backend.py), the A/B baseline:
                     kernel E (ops/paged_attention) and kernel C over
                     block tables
  FA_POD*         -> the contiguous arena through pod_backend.py: steps
                     that mix prefill and decode attend through kernel F
                     (ops/pod_fused, both phases in one launch), the
                     others through kernels B and C
  NO_OP           -> skip attention (profiling)

GPU-specific FA-vs-FI distinctions collapse (there is one kernel library
here), but every reference name is accepted and normalized so configs
written for the reference keep working.
"""

from __future__ import annotations

import enum


class AttentionBackend(enum.Enum):
    # ref enum values (attention/__init__.py:36-54)
    FA_PAGED = "fa_paged"
    FI_PAGED = "fi_paged"
    FA_VATTN = "fa_vattn"
    FA_VATTN_SYNC = "fa_vattn_sync"
    FI_VATTN = "fi_vattn"
    FI_VATTN_SYNC = "fi_vattn_sync"
    FA3_VATTN = "fa3_vattn"
    FA3_VATTN_SYNC = "fa3_vattn_sync"
    FA_VATTN_MEGACACHE = "fa_vattn_megacache"
    FA_VATTN_MEGACACHE_SYNC = "fa_vattn_megacache_sync"
    FA_POD = "fa_pod"
    FA_POD_MEGACACHE = "fa_pod_megacache"
    FA_STREAMS = "fa_streams"
    FA_STREAMS_MEGACACHE = "fa_streams_megacache"
    FI_UNPAGED = "fi_unpaged"
    FI_SERIAL_PAGED = "fi_serial_paged"
    NO_OP = "no_op"

    @staticmethod
    def resolve(name) -> "AttentionBackend":
        if isinstance(name, AttentionBackend):
            return name
        key = str(name).lower()
        # strip page-size suffixes like "fa_vattn_2mb" / "fa_paged_256";
        # the longest matching name wins, so "fa_vattn_sync" is
        # FA_VATTN_SYNC and not FA_VATTN with a suffix (the JAX package
        # takes the first match in enum order and loses the _sync and
        # _megacache variants, ROADMAP Queue 3)
        for backend in sorted(AttentionBackend, key=lambda b: -len(b.value)):
            if key == backend.value or key.startswith(backend.value + "_"):
                return backend
        raise ValueError(f"unknown attention backend {name!r}")

    @staticmethod
    def is_vATTN(backend) -> bool:
        """ref :56-103 classification helpers.

        FI_UNPAGED counts as contiguous: the reference implements it
        with a KVBuffer that stages each step's K/V contiguously
        (fi_unpaged wrapper + kv_buffer.py:6-83) and runs unpaged
        kernels over it -- on TPU that IS the contiguous-arena path, so
        it dispatches to the vattn engine rather than falling through
        to the paged one.
        """
        backend = AttentionBackend.resolve(backend)
        return "vattn" in backend.value or backend in (
            AttentionBackend.FA_POD, AttentionBackend.FA_POD_MEGACACHE,
            AttentionBackend.FA_STREAMS,
            AttentionBackend.FA_STREAMS_MEGACACHE,
            AttentionBackend.FI_UNPAGED)

    @staticmethod
    def is_vLLM(backend) -> bool:
        backend = AttentionBackend.resolve(backend)
        return backend in (AttentionBackend.FA_PAGED,
                           AttentionBackend.FI_PAGED,
                           AttentionBackend.FI_SERIAL_PAGED)

    @staticmethod
    def is_attn_contiguous(backend) -> bool:
        return AttentionBackend.is_vATTN(backend)

    @staticmethod
    def is_megacache(backend) -> bool:
        return "megacache" in AttentionBackend.resolve(backend).value

    @staticmethod
    def is_sync(backend) -> bool:
        return AttentionBackend.resolve(backend).value.endswith("_sync")

    @staticmethod
    def is_pod(backend) -> bool:
        backend = AttentionBackend.resolve(backend)
        return backend in (AttentionBackend.FA_POD,
                           AttentionBackend.FA_POD_MEGACACHE)

    @staticmethod
    def is_streams(backend) -> bool:
        backend = AttentionBackend.resolve(backend)
        return backend in (AttentionBackend.FA_STREAMS,
                           AttentionBackend.FA_STREAMS_MEGACACHE)

    @staticmethod
    def is_no_op(backend) -> bool:
        return AttentionBackend.resolve(backend) == AttentionBackend.NO_OP


def is_vattention_backend(backend) -> bool:
    return AttentionBackend.is_vATTN(backend)


def decode_page_size(name: str, default: int) -> int:
    """Parse trailing page-size suffix ("fa_vattn_2mb" -> 2MB,
    "fa_vattn_64kb" -> 64KB, "fa_paged_256" -> block size 256).

    ref: scripts/utils.py:70-99.
    """
    KB, MB = 1024, 1024 * 1024
    tail = name.lower().rsplit("_", 1)[-1]
    if tail.endswith("mb"):
        return int(tail[:-2]) * MB
    if tail.endswith("kb"):
        return int(tail[:-2]) * KB
    try:
        return int(tail)  # paged block size in tokens
    except ValueError:
        return default

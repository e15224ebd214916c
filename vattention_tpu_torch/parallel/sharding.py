"""The Megatron split of the llama family's weights and of the KV arena.

Counterpart of ``vattention_tpu/parallel/sharding.py``.  The JAX package
states the split as partition specs that ``shard_map`` applies; the port
applies the same split to tensors, one rank at a time
(``shard_params``): the fused qkv and gate_up projections are split on
their output axis, after ``regroup_qkv_for_tp`` and
``regroup_gate_up_for_tp`` have put each shard's heads (its gate and up
columns) side by side; o and down are split on their input axis (the
model sums their products over tp); the embeddings, the final norm and
the LM head are replicated; every ``layers.*`` stack keeps the stage's
``L / pp`` layers.  ``llama_param_specs`` states the split as the JAX
function does, one mesh axis name (or None) per tensor axis.  The arena of a rank is ``[L / pp, 2, Hkv / tp, R, D]``
(``kv_cache_shape``, the JAX ``kv_cache_spec``).

The kv heads must divide over tp (``num_kv_heads % tp == 0``).  The JAX
model also admits ``tp % num_kv_heads == 0``, but its
``regroup_qkv_for_tp`` then splits a head's dimensions across shards.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

TP_AXIS, PP_AXIS = "tp", "pp"


def llama_param_specs(tp_axis: Optional[str] = TP_AXIS,
                      pp_axis: Optional[str] = None,
                      qkv_bias: bool = False,
                      tie_word_embeddings: bool = False) -> Dict[str, Any]:
    """The JAX ``llama_param_specs`` as tuples: for each weight, the mesh
    axis that splits each of its axes (None: not split); ``layers.*`` carry
    the stacked [L] axis first."""
    lp = {
        "input_norm": (pp_axis,),
        "post_norm": (pp_axis,),
        "qkv_w": (pp_axis, None, tp_axis),
        "o_w": (pp_axis, tp_axis, None),
        "gate_up_w": (pp_axis, None, tp_axis),
        "down_w": (pp_axis, tp_axis, None),
    }
    if qkv_bias:
        lp["qkv_b"] = (pp_axis, tp_axis)
    specs = {"embed": (), "final_norm": (), "layers": lp}
    if not tie_word_embeddings:
        specs["lm_head"] = ()
    return specs


# each layer weight's spec, the bias included
_LAYER_SPECS = llama_param_specs(TP_AXIS, PP_AXIS, qkv_bias=True)["layers"]


def regroup_gate_up_for_tp(gate_up_w: torch.Tensor, tp: int) -> torch.Tensor:
    """Reorder fused [gate | up] columns into per-shard [gate_s | up_s]
    blocks so an even tp split is correct for silu_and_mul."""
    i2 = gate_up_w.shape[-1]
    gate = torch.chunk(gate_up_w[..., :i2 // 2], tp, dim=-1)
    up = torch.chunk(gate_up_w[..., i2 // 2:], tp, dim=-1)
    return torch.cat([torch.cat([g, u], dim=-1) for g, u in zip(gate, up)],
                     dim=-1)


def regroup_qkv_for_tp(qkv_w: torch.Tensor, num_q_heads: int,
                       num_kv_heads: int, head_dim: int,
                       tp: int) -> torch.Tensor:
    """Reorder fused qkv output columns [q | k | v] into per-shard
    [q_s | k_s | v_s] blocks so an even tp split hands each shard its own
    heads (also a qkv bias: the columns are its last axis)."""
    d = head_dim
    hq, hkv = num_q_heads, num_kv_heads
    q = torch.chunk(qkv_w[..., :hq * d], tp, dim=-1)
    k = torch.chunk(qkv_w[..., hq * d:(hq + hkv) * d], tp, dim=-1)
    v = torch.chunk(qkv_w[..., (hq + hkv) * d:], tp, dim=-1)
    return torch.cat([torch.cat([qs, ks, vs], dim=-1)
                      for qs, ks, vs in zip(q, k, v)], dim=-1)


def check_tp(arch, tp: int) -> None:
    """The split the port supports: q heads, kv heads and the MLP width
    each divide over tp."""
    if arch.num_kv_heads % tp or arch.num_q_heads % tp:
        raise ValueError(
            f"{arch.model_type}: {arch.num_q_heads} q and {arch.num_kv_heads}"
            f" kv heads do not divide over tp {tp} (num_kv_heads % tp must "
            "be 0)")
    if arch.intermediate_size % tp:
        raise ValueError(f"intermediate size {arch.intermediate_size} does "
                         f"not divide over tp {tp}")


class ShardLayout(NamedTuple):
    """One rank's slice of the model: its tp shard and pipeline stage."""
    tp: int = 1
    tp_rank: int = 0
    pp: int = 1
    pp_rank: int = 0

    @classmethod
    def of(cls, mesh) -> "ShardLayout":
        if mesh is None:
            return cls()
        return cls(mesh.tp_size, mesh.tp_rank, mesh.pp_size, mesh.pp_rank)

    @classmethod
    def of_config(cls, parallel_config) -> "ShardLayout":
        """The sizes of a ParallelConfig's mesh (rank 0's coordinates:
        enough for shapes)."""
        return cls(parallel_config.tensor_parallel_size, 0,
                   parallel_config.pipeline_parallel_size, 0)

    def stage_layers(self, num_layers: int) -> range:
        """The global indices of this stage's layers."""
        if num_layers % self.pp:
            raise ValueError(f"{num_layers} layers do not divide over pp "
                             f"{self.pp}")
        n = num_layers // self.pp
        return range(self.pp_rank * n, (self.pp_rank + 1) * n)

    def shard_layer(self, arch, name: str, w: torch.Tensor) -> torch.Tensor:
        """This rank's part of one layer's weight ``name`` (no [L] axis)."""
        if self.tp == 1:
            return w
        if name not in _LAYER_SPECS:
            raise NotImplementedError(
                f"no tensor-parallel split for the layer weight {name!r}")
        spec = _LAYER_SPECS[name]
        if TP_AXIS not in spec:
            return w
        axis = spec.index(TP_AXIS) - 1  # one layer: no [L] axis
        if name in ("qkv_w", "qkv_b"):
            w = regroup_qkv_for_tp(w, arch.num_q_heads, arch.num_kv_heads,
                                   arch.head_dim, self.tp)
        elif name == "gate_up_w":
            w = regroup_gate_up_for_tp(w, self.tp)
        return torch.chunk(w, self.tp, dim=axis)[self.tp_rank]


def shard_params(params: Dict[str, Any], arch,
                 layout: ShardLayout) -> Dict[str, Any]:
    """The one-rank model's params (port layout: ``layers`` stacked on
    [L]) -> this rank's: the stage's layers, each split over tp as
    ``llama_param_specs`` splits it, and the replicated tensors as they
    are.  Each layer is cut from the full one; the result's tensors are
    contiguous copies."""
    check_tp(arch, layout.tp)
    out: Dict[str, Any] = {k: v for k, v in params.items() if k != "layers"}
    replicated = llama_param_specs()
    for k in out:
        if k not in replicated:
            raise NotImplementedError(f"no split for the weight {k!r}")
    layers = layout.stage_layers(arch.num_layers)
    out["layers"] = {
        name: torch.stack([layout.shard_layer(arch, name, stack[l])
                           for l in layers]).contiguous()
        for name, stack in params["layers"].items()}
    return out


def kv_cache_shape(num_layers: int, num_kv_heads: int, rows: int,
                   head_dim: int, layout: Optional[ShardLayout] = None
                   ) -> tuple:
    """The rank-local arena ``[L / pp, 2, Hkv / tp, rows, D]``."""
    layout = layout or ShardLayout()
    return (num_layers // layout.pp, 2, num_kv_heads // layout.tp, rows,
            head_dim)

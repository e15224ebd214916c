"""Tensor and pipeline parallelism as torch.distributed ranks
(counterpart of ``vattention_tpu/parallel``)."""

from vattention_tpu_torch.parallel.mesh import make_serving_mesh
from vattention_tpu_torch.parallel.sharding import (llama_param_specs,
                                                    regroup_gate_up_for_tp,
                                                    regroup_qkv_for_tp)

__all__ = ["make_serving_mesh", "llama_param_specs",
           "regroup_gate_up_for_tp", "regroup_qkv_for_tp"]

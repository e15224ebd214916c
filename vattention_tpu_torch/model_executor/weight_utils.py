"""Weight loading (counterpart of vattention_tpu/model_executor/weight_utils.py).

Formats: "dummy" (seeded random weights drawn on the target device, one
layer at a time) and "zero".  ``params_from_jax`` carries a JAX
parameter pytree, converted to numpy by the caller, across unchanged: the
port keeps the JAX layout.  Local safetensors checkpoints are not ported
yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from vattention_tpu_torch.config import ModelConfig


def load_weights(model, model_config: ModelConfig, device: torch.device,
                 *, seed: int = 0) -> Dict[str, Any]:
    if model_config.load_format == "dummy":
        return model.init_params(device, seed=seed)
    if model_config.load_format == "zero":
        return model.init_params(device, zero=True)
    raise NotImplementedError(
        f"load_format {model_config.load_format!r} is not ported yet "
        "(ROADMAP Queue 1 item 6)")


def params_from_jax(np_params: Mapping[str, Any], *, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """JAX parameter pytree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives) -> the port's params.

    Both packages keep per-layer weights stacked on a leading [L] axis and
    projections as [in, out], so this is a copy with a dtype cast.
    """
    def convert(x):
        if isinstance(x, Mapping):
            return {k: convert(v) for k, v in x.items()}
        return torch.from_numpy(
            np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)

    return convert(np_params)

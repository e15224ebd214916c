"""Weight loading (counterpart of vattention_tpu/model_executor/weight_utils.py).

Formats: "dummy" (seeded random weights drawn on the target device, one
layer at a time), "zero", and "safetensors" (a local HF llama-family
checkpoint directory).  ``params_from_jax`` carries a JAX parameter
pytree, converted to numpy by the caller, across unchanged: the port keeps
the JAX layout.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from vattention_tpu_torch.config import ModelConfig
from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


def load_weights(model, model_config: ModelConfig, device: torch.device,
                 *, seed: int = 0) -> Dict[str, Any]:
    if model_config.load_format == "dummy":
        return model.init_params(device, seed=seed)
    if model_config.load_format == "zero":
        return model.init_params(device, zero=True)
    if model_config.load_format == "safetensors":
        return load_safetensors(model, model_config, device)
    raise ValueError(f"unknown load_format {model_config.load_format!r}")


def _hf_layer_names(model) -> Dict[str, tuple]:
    """HF name inside ``model.layers.<l>.`` -> (the port's stacked layer
    param, the columns of its last axis the tensor fills, or None for all).
    Every 2-D HF weight is [out, in] and lands transposed."""
    a = model.arch
    qd, kvd, inter = a.q_dim, a.kv_dim, a.intermediate_size
    q, k, v = (slice(0, qd), slice(qd, qd + kvd),
               slice(qd + kvd, qd + 2 * kvd))
    names = {
        "self_attn.q_proj.weight": ("qkv_w", q),
        "self_attn.k_proj.weight": ("qkv_w", k),
        "self_attn.v_proj.weight": ("qkv_w", v),
        "self_attn.o_proj.weight": ("o_w", None),
        "mlp.gate_proj.weight": ("gate_up_w", slice(0, inter)),
        "mlp.up_proj.weight": ("gate_up_w", slice(inter, 2 * inter)),
        "mlp.down_proj.weight": ("down_w", None),
        "input_layernorm.weight": ("input_norm", None),
        "post_attention_layernorm.weight": ("post_norm", None),
    }
    if a.qkv_bias:
        names.update({"self_attn.q_proj.bias": ("qkv_b", q),
                      "self_attn.k_proj.bias": ("qkv_b", k),
                      "self_attn.v_proj.bias": ("qkv_b", v)})
    return names


def load_safetensors(model, model_config: ModelConfig,
                     device: torch.device) -> Dict[str, Any]:
    """Load the ``*.safetensors`` files under ``model_config.model`` (HF
    llama-family names) into the port's stacked params on ``device``.

    The JAX loader at tp_rank 0, in another memory shape: each stacked
    tensor is allocated once on ``device``, and the checkpoint is read one
    tensor at a time and copied into its place, so the host holds about
    one tensor.  q/k/v (and their biases) fill ``qkv_w`` (``qkv_b``),
    gate/up fill ``gate_up_w``, [out, in] projections land as [in, out],
    and ``lm_head`` is read unless the embeddings are tied.  Tensors of any
    dtype torch reads (bf16 included) are cast to the model's.
    """
    from safetensors import safe_open

    files = sorted(glob.glob(os.path.join(model_config.model,
                                          "*.safetensors")))
    if not files:
        raise FileNotFoundError(
            f"no *.safetensors under {model_config.model!r}")
    keys = {}
    for f in files:
        with safe_open(f, framework="pt") as sf:
            keys.update(dict.fromkeys(sf.keys(), f))
    if any(k.startswith("transformer.h.") for k in keys):
        raise NotImplementedError(
            "falcon's checkpoint layout (transformer.h.*) is not ported yet "
            "(ROADMAP Queue 1 item 12)")

    params: Dict[str, Any] = {"layers": {}}
    for name, shape in model.param_shapes().items():
        t = torch.empty(shape, dtype=model.dtype, device=device)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    # HF name -> the view of a port param it fills
    targets = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        targets["lm_head.weight"] = params["lm_head"]
    for l in range(model.arch.num_layers):
        for hf, (dst, cols) in _hf_layer_names(model).items():
            view = params["layers"][dst][l]
            targets[f"model.layers.{l}.{hf}"] = (
                view if cols is None else view[..., cols])
    missing = sorted(set(targets) - set(keys))
    if missing:
        raise KeyError(f"{model_config.model}: the checkpoint lacks "
                       f"{len(missing)} tensors, e.g. {missing[:4]}")

    by_file: Dict[str, list] = {}
    for name in targets:
        by_file.setdefault(keys[name], []).append(name)
    for f, names in by_file.items():
        with safe_open(f, framework="pt") as sf:
            for name in names:
                src = sf.get_tensor(name).to(device)
                # embeddings are [vocab, hidden] in both layouts
                if src.dim() == 2 and name != "model.embed_tokens.weight":
                    src = src.T
                dst = targets[name]
                if src.shape != dst.shape:
                    raise ValueError(f"{name}: shape {tuple(src.shape)} "
                                     f"does not fit {tuple(dst.shape)}")
                dst.copy_(src)
                del src
    logger.info("loaded %d safetensors tensors from %s (%d files)",
                len(targets), model_config.model, len(files))
    return params


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

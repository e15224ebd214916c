"""Weight loading (counterpart of vattention_tpu/model_executor/weight_utils.py).

Formats: "dummy" (seeded random weights drawn on the target device, one
layer at a time), "zero", and "safetensors" (a local HF checkpoint
directory: the llama family's ``model.layers.*`` names or falcon's
``transformer.h.*``).  ``params_from_jax`` carries a JAX parameter
pytree, converted to numpy by the caller, across unchanged: the port keeps
the JAX layout.

A model of one rank of a tensor- or pipeline-parallel mesh (its
``layout``, ``parallel.sharding.ShardLayout``) gets that rank's shard:
every format draws or reads each full layer exactly as the one-rank model
does and keeps the rank's part, so the ranks together hold the one-rank
model's weights.  JAX parameters reach a rank through ``params_from_jax``
and then ``parallel.sharding.shard_params``.
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
        if model.layout.tp > 1 or model.layout.pp > 1:
            return load_safetensors_shard(model, model_config, device)
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


def _checkpoint_keys(model_config: ModelConfig) -> Dict[str, str]:
    """Tensor name -> the ``*.safetensors`` file under
    ``model_config.model`` that holds it."""
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
    return keys


def _empty_params(model, device: torch.device) -> Dict[str, Any]:
    """The model's params, allocated once on ``device`` and unfilled."""
    params: Dict[str, Any] = {"layers": {}}
    for name, shape in model.param_shapes().items():
        t = torch.empty(shape, dtype=model.dtype, device=device)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def _fill(targets: Dict[str, list], keys: Dict[str, str],
          model_config: ModelConfig, device: torch.device) -> None:
    """Copy each checkpoint tensor into its targets, (view, transpose)
    pairs, reading one tensor at a time, file by file."""
    from safetensors import safe_open

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
                for dst, transpose in targets[name]:
                    val = src.T if transpose else src
                    if val.shape != dst.shape:
                        raise ValueError(
                            f"{name}: shape {tuple(val.shape)} does not fit "
                            f"{tuple(dst.shape)}")
                    dst.copy_(val)
                del src
    logger.info("loaded %d safetensors tensors from %s (%d files)",
                len(targets), model_config.model, len(by_file))


def load_safetensors(model, model_config: ModelConfig,
                     device: torch.device) -> Dict[str, Any]:
    """Load the ``*.safetensors`` files under ``model_config.model`` (HF
    llama-family names) into the port's stacked params on ``device``;
    falcon goes to ``load_safetensors_falcon``, as in the JAX loader.

    The JAX loader at tp_rank 0, in another memory shape: each stacked
    tensor is allocated once on ``device``, and the checkpoint is read one
    tensor at a time and copied into its place, so the host holds about
    one tensor.  q/k/v (and their biases) fill ``qkv_w`` (``qkv_b``),
    gate/up fill ``gate_up_w``, [out, in] projections land as [in, out],
    and ``lm_head`` is read unless the embeddings are tied.  Tensors of any
    dtype torch reads (bf16 included) are cast to the model's.
    """
    if model.arch.model_type == "falcon":
        return load_safetensors_falcon(model, model_config, device)
    keys = _checkpoint_keys(model_config)
    params = _empty_params(model, device)
    # HF name -> the view of a port param it fills; embeddings are
    # [vocab, hidden] in both layouts, every other 2-D weight transposed
    targets = {"model.embed_tokens.weight": [(params["embed"], False)],
               "model.norm.weight": [(params["final_norm"], False)]}
    if "lm_head" in params:
        targets["lm_head.weight"] = [(params["lm_head"], True)]
    for l in range(model.arch.num_layers):
        for hf, (dst, cols) in _hf_layer_names(model).items():
            view = params["layers"][dst][l]
            targets[f"model.layers.{l}.{hf}"] = [(
                view if cols is None else view[..., cols], view.dim() == 2)]
    _fill(targets, keys, model_config, device)
    return params


def load_safetensors_shard(model, model_config: ModelConfig,
                           device: torch.device) -> Dict[str, Any]:
    """``load_safetensors`` for one rank of a mesh: the replicated tensors
    are read whole; each layer of the rank's stage is read into full-layer
    buffers, one layer at a time, and its tp shard kept
    (``ShardLayout.shard_layer``)."""
    keys = _checkpoint_keys(model_config)
    layout, arch = model.layout, model.arch
    params: Dict[str, Any] = {"layers": {}}
    layer_shapes = {}
    for name, shape in model.param_shapes().items():
        if name.startswith("layers."):
            layer_shapes[name[len("layers."):]] = shape[1:]
        else:
            params[name] = torch.empty(shape, dtype=model.dtype, device=device)
    targets = {"model.embed_tokens.weight": [(params["embed"], False)],
               "model.norm.weight": [(params["final_norm"], False)]}
    if "lm_head" in params:
        targets["lm_head.weight"] = [(params["lm_head"], True)]
    _fill(targets, keys, model_config, device)
    stage = layout.stage_layers(arch.num_layers)
    for name, shape in layer_shapes.items():
        local = layout.shard_layer(arch, name,
                                   torch.empty(shape, device="meta"))
        params["layers"][name] = torch.empty(
            (len(stage),) + tuple(local.shape), dtype=model.dtype,
            device=device)
    for l in stage:
        full = {name: torch.empty(shape, dtype=model.dtype, device=device)
                for name, shape in layer_shapes.items()}
        targets = {}
        for hf, (dst, cols) in _hf_layer_names(model).items():
            view = full[dst]
            targets[f"model.layers.{l}.{hf}"] = [(
                view if cols is None else view[..., cols], view.dim() == 2)]
        _fill(targets, keys, model_config, device)
        for name, w in full.items():
            params["layers"][name][l - stage.start].copy_(
                layout.shard_layer(arch, name, w))
    return params


# falcon's name inside ``transformer.h.<l>.`` -> the port's stacked param
_FALCON_LAYER_NAMES = {
    "self_attention.query_key_value.weight": "qkv_w",
    "self_attention.dense.weight": "o_w",
    "mlp.dense_h_to_4h.weight": "up_w",
    "mlp.dense_4h_to_h.weight": "down_w",
    "input_layernorm.weight": "input_norm",
    "input_layernorm.bias": "input_norm_b",
}


def load_safetensors_falcon(model, model_config: ModelConfig,
                            device: torch.device) -> Dict[str, Any]:
    """Load a Falcon-7B-layout checkpoint (``transformer.h.{l}.*``: the
    fused MQA ``query_key_value`` laid out [q | k | v], one LayerNorm with
    a bias per layer, ``transformer.ln_f``) into the falcon params on
    ``device``: the counterpart of the JAX ``load_safetensors_falcon``, in
    ``load_safetensors``'s memory shape (params allocated once, one
    checkpoint tensor at a time).  [out, in] weights land as [in, out];
    ``lm_head`` is ``lm_head.weight`` transposed, or the word embeddings
    transposed where the checkpoint has no head."""
    keys = _checkpoint_keys(model_config)
    params = _empty_params(model, device)
    targets = {
        "transformer.word_embeddings.weight": [(params["embed"], False)],
        "transformer.ln_f.weight": [(params["final_norm"], False)],
        "transformer.ln_f.bias": [(params["final_norm_b"], False)]}
    head = (params["lm_head"], True)
    if "lm_head.weight" in keys:
        targets["lm_head.weight"] = [head]
    else:
        targets["transformer.word_embeddings.weight"].append(head)
    lp = params["layers"]
    for l in range(model.arch.num_layers):
        for hf, dst in _FALCON_LAYER_NAMES.items():
            view = lp[dst][l]
            targets[f"transformer.h.{l}.{hf}"] = [(view, view.dim() == 2)]
    _fill(targets, keys, model_config, device)
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

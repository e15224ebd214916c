"""Metric name enums (ref: sarathi-lean/sarathi/metrics/constants.py:6-106)."""

import enum


class OperationMetrics(enum.Enum):
    """Per-op device timing categories (ref :6-32; CUDA-event names like
    NCCL_SEND/RECV map to their compiled-collective analogs)."""

    MLP_UP_PROJ = "mlp_up_proj"
    MLP_DOWN_PROJ = "mlp_down_proj"
    MLP_ACTIVATION = "mlp_activation"
    ATTN_PRE_PROJ = "attn_pre_proj"
    ATTN_POST_PROJ = "attn_post_proj"
    ATTN_KV_CACHE_SAVE = "attn_kv_cache_save"
    ATTN_PREFILL = "attn_prefill"
    ATTN_DECODE = "attn_decode"
    ATTN_ROPE = "attn_rope"
    ATTN_INPUT_RESHAPE = "attn_input_reshape"
    ATTN_OUTPUT_RESHAPE = "attn_output_reshape"
    EMBED_LINEAR = "embed_linear"
    EMBED_ALL_REDUCE = "embed_all_reduce"
    LM_HEAD_LINEAR = "lm_head_linear"
    LM_HEAD_ALL_GATHER = "lm_head_all_gather"
    INPUT_LAYERNORM = "input_layernorm"
    POST_ATTENTION_LAYERNORM = "post_attention_layernorm"
    NORM = "norm"
    ADD = "add"
    TP_ALL_REDUCE = "tp_all_reduce"      # nccl_all_reduce analog
    PP_SEND_RECV = "pp_send_recv"        # nccl_send/recv analog
    SAMPLER = "sample"
    KV_RELOCATION = "kv_relocation"      # TPU-specific: arena copies


class CpuOperationMetrics(enum.Enum):
    """ref :34-52."""

    SCHEDULE = "schedule"
    PREPARE_INPUTS = "prepare_inputs_e2e"
    MODEL_EXECUTION = "model_execution_e2e"
    SAMPLER_E2E = "sampler_e2e"
    PROCESS_MODEL_OUTPUTS = "process_model_outputs"
    KV_STEP = "kv_cache_step"            # allocator step_async time

from .attention import (
    apply_rope,
    causal_attention,
    causal_attention_xla,
    paged_decode_attention,
    paged_decode_attention_xla,
    paged_multitoken_attention,
    repeat_kv,
    rope_freqs,
)
from .convert import bank_from_jax, params_from_jax
from .llama import (
    GEMMA2_9B,
    LLAMA3_1B,
    LLAMA3_8B,
    LLAMA3_70B,
    MISTRAL_7B,
    QWEN3_8B,
    QWEN25_7B,
    TINY,
    LlamaConfig,
    decode_forward,
    init_params,
    loss_fn,
    prefill_forward,
    rmsnorm,
    scaled,
    train_step_fn,
    verify_forward,
)
from .lora import LoraBank, init_lora_bank, merge_lora
from .moe import (
    MIXTRAL_8X7B,
    TINY_MOE,
    MoEConfig,
    init_moe_params,
    moe_decode_forward,
    moe_loss_fn,
    moe_prefill_forward,
    moe_train_step_fn,
    moe_verify_forward,
    scaled_moe,
)

__all__ = [
    "apply_rope", "causal_attention", "causal_attention_xla",
    "paged_decode_attention", "paged_decode_attention_xla",
    "paged_multitoken_attention", "repeat_kv",
    "rope_freqs", "params_from_jax", "GEMMA2_9B", "LLAMA3_1B", "LLAMA3_8B",
    "LLAMA3_70B", "MISTRAL_7B", "QWEN3_8B", "QWEN25_7B", "TINY",
    "LlamaConfig", "decode_forward", "init_params", "loss_fn",
    "prefill_forward", "rmsnorm", "scaled", "train_step_fn",
    "verify_forward", "bank_from_jax", "LoraBank",
    "init_lora_bank", "merge_lora", "MIXTRAL_8X7B", "TINY_MOE", "MoEConfig",
    "init_moe_params", "moe_decode_forward", "moe_loss_fn",
    "moe_prefill_forward", "moe_train_step_fn", "moe_verify_forward",
    "scaled_moe",
]

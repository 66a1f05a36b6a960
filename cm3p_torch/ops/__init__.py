"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from .attention import (
    attention,
    segment_attention,
    segment_attention_dkv,
    segment_attention_dq,
    segment_attention_plain,
    window_attention,
    window_attention_dkv,
    window_attention_dq,
    window_attention_plain,
)
from .fused_ffn import fused_ln_ffn, fused_ln_ffn_plain, layer_norm_f32

KERNELS = {
    "window_attention": window_attention,
    "segment_attention": segment_attention,
    "fused_ln_ffn": fused_ln_ffn,
    "window_attention_dq": window_attention_dq,
    "window_attention_dkv": window_attention_dkv,
    "segment_attention_dq": segment_attention_dq,
    "segment_attention_dkv": segment_attention_dkv,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "attention",
    "fused_ln_ffn",
    "fused_ln_ffn_plain",
    "launch_counts",
    "layer_norm_f32",
    "reset_launch_counts",
    "segment_attention",
    "segment_attention_dkv",
    "segment_attention_dq",
    "segment_attention_plain",
    "window_attention",
    "window_attention_dkv",
    "window_attention_dq",
    "window_attention_plain",
]

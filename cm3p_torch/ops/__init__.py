"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version."""
from .attention import (
    attention,
    segment_attention,
    segment_attention_dkv,
    segment_attention_dkv_rope,
    segment_attention_dq,
    segment_attention_dq_rope,
    segment_attention_plain,
    segment_attention_rect,
    segment_attention_rect_plain,
    segment_attention_wo,
    segment_attention_wo_plain,
    segment_attention_wo_q,
    segment_attention_wo_q_plain,
    window_attention,
    window_attention_dkv,
    window_attention_dkv_rope,
    window_attention_dq,
    window_attention_dq_rope,
    window_attention_plain,
    window_attention_wo,
    window_attention_wo_plain,
    window_attention_wo_q,
    window_attention_wo_q_plain,
    wo_fusable,
    wo_shape_ok,
)
from .fused_ffn import fused_ln_ffn, fused_ln_ffn_plain, fused_ln_ffn_q, fused_ln_ffn_q_wo, fused_ln_ffn_wo, layer_norm_f32
from .fused_ln_matmul import (
    fused_ln_matmul,
    fused_ln_matmul_plain,
    fused_ln_matmul_q,
    fused_ln_matmul_q_plain,
    fused_ln_matmul_q_wo,
    fused_ln_matmul_wo,
    lnmm_fusable,
)
from .quant import int8_matmul, quant_rows_int8, quantize_weight_int8
from .attention import segment_attention_f32, segment_attention_rect_f32, window_attention_f32
from .fused_ffn import fused_ln_ffn_f32, fused_ln_ffn_q_f32, fused_ln_ffn_q_wo_f32, fused_ln_ffn_wo_f32
from .fused_ln_matmul import (
    fused_ln_matmul_f32,
    fused_ln_matmul_q_f32,
    fused_ln_matmul_q_wo_f32,
    fused_ln_matmul_wo_f32,
)

# one name per kernel, and per form of a kernel whose work differs: what holds each name's launch count
KERNELS = {
    "window_attention": window_attention,
    "segment_attention": segment_attention,
    "fused_ln_ffn": fused_ln_ffn,
    "window_attention_dq": window_attention_dq,
    "window_attention_dkv": window_attention_dkv,
    "segment_attention_dq": segment_attention_dq,
    "segment_attention_dkv": segment_attention_dkv,
    "fused_ln_ffn_q": fused_ln_ffn_q,
    "fused_ln_matmul": fused_ln_matmul,
    "fused_ln_matmul_q": fused_ln_matmul_q,
    "fused_ln_ffn_q_wo": fused_ln_ffn_q_wo,
    "fused_ln_ffn_wo": fused_ln_ffn_wo,
    "fused_ln_matmul_wo": fused_ln_matmul_wo,
    "fused_ln_matmul_q_wo": fused_ln_matmul_q_wo,
    "window_attention_wo": window_attention_wo,
    "window_attention_wo_q": window_attention_wo_q,
    "segment_attention_wo": segment_attention_wo,
    "segment_attention_wo_q": segment_attention_wo_q,
    "window_attention_dq_rope": window_attention_dq_rope,
    "window_attention_dkv_rope": window_attention_dkv_rope,
    "segment_attention_dq_rope": segment_attention_dq_rope,
    "segment_attention_dkv_rope": segment_attention_dkv_rope,
    "segment_attention_rect": segment_attention_rect,
    # the fp32 kernels' forms (a model run in fp32; no-grad)
    "window_attention_f32": window_attention_f32,
    "segment_attention_f32": segment_attention_f32,
    "segment_attention_rect_f32": segment_attention_rect_f32,
    "fused_ln_ffn_f32": fused_ln_ffn_f32,
    "fused_ln_ffn_q_f32": fused_ln_ffn_q_f32,
    "fused_ln_ffn_q_wo_f32": fused_ln_ffn_q_wo_f32,
    "fused_ln_ffn_wo_f32": fused_ln_ffn_wo_f32,
    "fused_ln_matmul_f32": fused_ln_matmul_f32,
    "fused_ln_matmul_wo_f32": fused_ln_matmul_wo_f32,
    "fused_ln_matmul_q_f32": fused_ln_matmul_q_f32,
    "fused_ln_matmul_q_wo_f32": fused_ln_matmul_q_wo_f32,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: counter.launches for name, counter in KERNELS.items()}


def reset_launch_counts() -> None:
    for counter in KERNELS.values():
        counter.launches = 0


__all__ = [
    "KERNELS",
    "attention",
    "fused_ln_ffn",
    "fused_ln_ffn_plain",
    "fused_ln_ffn_q",
    "fused_ln_matmul",
    "fused_ln_matmul_plain",
    "fused_ln_matmul_q",
    "fused_ln_matmul_q_plain",
    "int8_matmul",
    "launch_counts",
    "layer_norm_f32",
    "lnmm_fusable",
    "quant_rows_int8",
    "quantize_weight_int8",
    "reset_launch_counts",
    "segment_attention",
    "segment_attention_dkv",
    "segment_attention_dkv_rope",
    "segment_attention_dq",
    "segment_attention_dq_rope",
    "segment_attention_plain",
    "segment_attention_rect",
    "segment_attention_rect_plain",
    "segment_attention_wo",
    "segment_attention_wo_plain",
    "segment_attention_wo_q",
    "segment_attention_wo_q_plain",
    "window_attention",
    "window_attention_dkv",
    "window_attention_dkv_rope",
    "window_attention_dq",
    "window_attention_dq_rope",
    "window_attention_plain",
    "window_attention_wo",
    "window_attention_wo_plain",
    "window_attention_wo_q",
    "window_attention_wo_q_plain",
    "wo_fusable",
    "wo_shape_ok",
]

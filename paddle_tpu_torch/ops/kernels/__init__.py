"""Hand-written Hopper kernels, each with its plain PyTorch version.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

__all__ = ["launch_counters"]


def launch_counters():
    """Each kernel's name -> (its wrapper, the attribute that counts its
    launches). The decode kernel's quant mode and the flash kernels' fp32
    instance are counted apart, on the same wrappers."""
    from . import blocked_matmul as bm
    from . import decode_attention as da
    from . import flash_attention as fa
    from . import flash_variants as fv
    from . import head_dx as hd
    from . import multi_tensor_update as mtu
    from . import paged_attention as pa
    from . import quant_matmul as qm
    from . import tick_fusion as tf

    return {"ragged_decode_attention": (da.ragged_decode_attention,
                                        "launches"),
            "ragged_decode_attention_quant": (da.ragged_decode_attention,
                                              "quant_launches"),
            "fused_rms_norm": (tf.fused_rms_norm, "launches"),
            "fused_add_rms_norm": (tf.fused_add_rms_norm, "launches"),
            "fused_rope_qk": (tf.fused_rope_qk, "launches"),
            "ragged_paged_attention": (pa.ragged_paged_attention,
                                       "launches"),
            "flash_attention_fwd": (fa.flash_attention_fwd, "launches"),
            "flash_attention_bwd": (fa.flash_attention_bwd, "launches"),
            "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,
                                       "launches"),
            "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,
                                        "launches"),
            "flash_attention_fwd_f32": (fa.flash_attention_fwd,
                                        "f32_launches"),
            "flash_attention_bwd_f32": (fa.flash_attention_bwd,
                                        "f32_launches"),
            "flash_attention_bwd_dq_f32": (fa.flash_attention_bwd_dq,
                                           "f32_launches"),
            "flash_attention_bwd_dkv_f32": (fa.flash_attention_bwd_dkv,
                                            "f32_launches"),
            "head_dx_softmax": (hd.head_dx_softmax, "launches"),
            "quant_matmul": (qm.quant_matmul, "launches"),
            "multi_tensor_update": (mtu.multi_tensor_update, "launches"),
            "blocked_matmul": (bm.blocked_matmul, "launches"),
            "flash_variants_fwd": (fv.variant_fwd, "launches"),
            "flash_variants_bwd": (fv.variant_bwd, "launches")}

"""Hand-written Hopper kernels (CUDA C++ for sm_90a) and their wrappers."""

from .block_sparse_prefill import (slash_tile_attention,
                                   slash_tile_attention_db,
                                   vertical_attention_partials)
from .decode_attn import decode_attention
from .flash_prefill import (flash_attention_partials, flash_causal_attention,
                            flash_pass_b, flash_row_max)
from .h2o_scores import h2o_colsum, h2o_row_stats, h2o_scores
from .int4_matmul import int4_matmul, int4_matmul_dma, int8_matmul
from .quant_decode import (quant_decode_attention,
                           quant_decode_attention_tiled,
                           quant_fused_attention_group)
from .quant_fused_decode import quant_fused_attention_pa

__all__ = ["decode_attention", "flash_attention_partials",
           "flash_causal_attention", "flash_pass_b", "flash_row_max",
           "h2o_colsum", "h2o_row_stats",
           "h2o_scores", "int4_matmul",
           "int4_matmul_dma", "int8_matmul", "quant_decode_attention",
           "quant_decode_attention_tiled", "quant_fused_attention_group",
           "quant_fused_attention_pa",
           "slash_tile_attention", "slash_tile_attention_db",
           "vertical_attention_partials"]

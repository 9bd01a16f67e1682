"""Typed configuration of the port: a copy of ``pyramidkv_tpu/config.py``.

The port keeps its own copy because importing the JAX package's module would
run ``pyramidkv_tpu/__init__.py``, which imports JAX.  Field names, defaults,
presets and validation are the same, so specs built for either package
describe the same model, policy and engine.  Many fields select features
not ported yet: the port raises for those that change results (KVQuant
and 1- or 3-bit KIVI, model families, sampling, speculation) and ignores the
TPU tiling knobs (``prefill_block``, ``prefill_sub_k``,
``use_quant_fused_kernel``), which do not.  ``prefill_two_pass`` runs the
two-pass flash kernels; ``use_quant_kernel`` / ``use_quant_tiled`` route
group-layout KIVI regions to the f32 region kernels (JAX's opt-in route)
unless ``use_quant_fused`` names the default factored one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Method registry
# ---------------------------------------------------------------------------

#: All compression methods accepted by the engine.  Mirrors the reference's
#: dispatch strings (pyramidkv/monkeypatch.py:21-84).
METHODS = (
    "fullkv",
    "snapkv",
    "pyramidkv",
    "h2o",
    "streamingllm",
    "l2norm",
    "cam",
    "adakv",
    "headkv",
    "think",
    "random",
    "minference",
)

#: Methods that use the SnapKV-style observation window score.
WINDOW_SCORE_METHODS = ("snapkv", "pyramidkv", "adakv", "headkv", "think", "cam")


# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelSpec:
    """Decoder-only transformer architecture description (Llama / Mistral).

    Field names follow HF ``config.json`` so that :func:`ModelSpec.from_hf`
    is a direct mapping.
    """

    name: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    sliding_window: Optional[int] = None  # Mistral-v0.1 style sliding window
    attention_bias: bool = False
    #: Mixtral-style MoE: number of local experts (0 = dense MLP) and
    #: active experts per token (top-k routing).  The reference lists
    #: Mixtral as an unchecked TODO (README.md:45).
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    #: MoE prefill FLOP control.  None (default) = exact dense-all-experts
    #: compute (every token runs every expert; zero routing weights
    #: contribute exactly 0).  A float C enables capacity-factor token
    #: dispatch: each expert processes at most
    #: ``ceil(chunk * top_k / E * C)`` tokens per prefill chunk (one-hot
    #: MXU dispatch/combine, no gathers) — cutting expert-FFN FLOPs by
    #: ~``E / (top_k * C)`` vs dense.  Tokens routed to an expert past its
    #: capacity lose that expert's contribution (standard MoE dropping;
    #: weights are NOT renormalised).  ``C >= E / top_k`` is provably
    #: drop-free and bit-matches the dense path.  Decode always runs dense
    #: (a single token's expert weights dominate HBM, not FLOPs).
    moe_capacity_factor: Optional[float] = None
    # --- Gemma-2 family knobs (modeling_gemma2.py semantics) --------------
    #: MLP activation: "silu" (Llama/Mistral/Qwen) or "gelu_tanh"
    #: (Gemma-2's gelu_pytorch_tanh).
    hidden_act: str = "silu"
    #: Softmax scale denominator: attention uses
    #: ``query_pre_attn_scalar**-0.5`` when set (Gemma-2: 256), else
    #: ``head_dim**-0.5``.
    query_pre_attn_scalar: Optional[float] = None
    #: tanh soft-capping of attention logits (Gemma-2: 50.0) applied to the
    #: SCALED logits before masking (eager_attention_forward order).
    attn_logit_softcapping: Optional[float] = None
    #: tanh soft-capping of the final LM logits (Gemma-2: 30.0).
    final_logit_softcapping: Optional[float] = None
    #: RMSNorm computes ``(1 + w)`` in fp32 then casts (Gemma2RMSNorm);
    #: norm weights are zero-initialised under this convention.
    rmsnorm_unit_offset: bool = False
    #: Multiply embeddings by ``sqrt(hidden_size)`` (rounded through the
    #: activation dtype, matching HF's dtype-cast normalizer).
    scale_embeddings: bool = False
    #: Gemma-2 block structure: post-attention and post-feedforward norms
    #: (4 RMSNorms per layer instead of 2).
    post_block_norms: bool = False
    #: Per-layer attention types ("sliding_attention" | "full_attention").
    #: None = uniform (``sliding_window`` applies to every layer, Mistral
    #: style).  Gemma-2 alternates: even layers sliding, odd full.
    layer_types: Optional[Tuple[str, ...]] = None
    # Llama-3.1+ rope scaling ("llama3" frequency scaling); None = plain RoPE.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192

    @property
    def num_query_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def attn_scale(self) -> float:
        """Softmax scale: ``query_pre_attn_scalar**-0.5`` when set
        (Gemma-2), else the standard ``head_dim**-0.5``."""
        denom = self.query_pre_attn_scalar or self.head_dim
        return float(denom) ** -0.5

    @property
    def mixed_sliding(self) -> bool:
        """True when layers alternate sliding/full attention (Gemma-2)."""
        return (self.sliding_window is not None
                and self.layer_types is not None
                and len(set(self.layer_types)) > 1)

    def layer_is_sliding(self, i: int) -> bool:
        """Static: does layer ``i`` use the sliding window?"""
        if self.sliding_window is None:
            return False
        if self.layer_types is None:
            return True
        return self.layer_types[i] == "sliding_attention"

    def layer_window(self, i: int) -> Optional[int]:
        """Static per-layer window (None = full attention)."""
        return self.sliding_window if self.layer_is_sliding(i) else None

    @staticmethod
    def from_hf(config: dict, name: str = "model") -> "ModelSpec":
        """Build a spec from a HF ``config.json`` dict (Llama or Mistral)."""
        rope_scaling = config.get("rope_scaling") or {}
        head_dim = config.get("head_dim") or (
            config["hidden_size"] // config["num_attention_heads"]
        )
        gemma2 = config.get("model_type") == "gemma2"
        act = config.get("hidden_activation") or config.get("hidden_act")
        layer_types = config.get("layer_types")
        if gemma2 and layer_types is None:
            # configuration_gemma2.py default: even layers sliding, odd full
            layer_types = tuple(
                "sliding_attention" if (i + 1) % 2 else "full_attention"
                for i in range(config["num_hidden_layers"])
            )
        return ModelSpec(
            name=name,
            vocab_size=config["vocab_size"],
            hidden_size=config["hidden_size"],
            intermediate_size=config["intermediate_size"],
            num_hidden_layers=config["num_hidden_layers"],
            num_attention_heads=config["num_attention_heads"],
            num_key_value_heads=config.get(
                "num_key_value_heads", config["num_attention_heads"]
            ),
            head_dim=head_dim,
            rms_norm_eps=config.get("rms_norm_eps", 1e-5),
            rope_theta=config.get("rope_theta", 10000.0),
            max_position_embeddings=config.get("max_position_embeddings", 8192),
            # Gemma-2's config omits the key; its Config class defaults True
            tie_word_embeddings=config.get("tie_word_embeddings", gemma2),
            sliding_window=config.get("sliding_window"),
            # Qwen2's HF config carries no attention_bias key — its
            # attention hardcodes bias=True on q/k/v (modeling_qwen2)
            attention_bias=config.get(
                "attention_bias", config.get("model_type") == "qwen2"),
            num_local_experts=config.get("num_local_experts", 0) or 0,
            num_experts_per_tok=config.get("num_experts_per_tok", 2),
            hidden_act=("gelu_tanh" if act in ("gelu_pytorch_tanh",
                                               "gelu_tanh") else "silu"),
            query_pre_attn_scalar=config.get("query_pre_attn_scalar"),
            attn_logit_softcapping=config.get("attn_logit_softcapping"),
            final_logit_softcapping=config.get("final_logit_softcapping"),
            rmsnorm_unit_offset=gemma2,
            scale_embeddings=gemma2,
            post_block_norms=gemma2,
            layer_types=tuple(layer_types) if layer_types else None,
            rope_scaling_type=rope_scaling.get("rope_type") or rope_scaling.get("type"),
            rope_scaling_factor=rope_scaling.get("factor", 1.0),
            rope_low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
            rope_high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
            rope_original_max_position=rope_scaling.get(
                "original_max_position_embeddings", 8192
            ),
        )

    @staticmethod
    def preset(name: str, **overrides) -> "ModelSpec":
        """Named architecture presets for the reference's model grid
        (README.md:29: Llama-2/3, Llama-3-70B, Mistral-7B)."""
        presets = {
            "llama2-7b": dict(
                name="llama2-7b", vocab_size=32000, hidden_size=4096,
                intermediate_size=11008, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=32, head_dim=128,
                rope_theta=10000.0, max_position_embeddings=4096,
                rms_norm_eps=1e-5,
            ),
            "llama3-8b": dict(
                name="llama3-8b", vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                rope_theta=500000.0, max_position_embeddings=8192,
                rms_norm_eps=1e-5,
            ),
            "llama3-70b": dict(
                name="llama3-70b", vocab_size=128256, hidden_size=8192,
                intermediate_size=28672, num_hidden_layers=80,
                num_attention_heads=64, num_key_value_heads=8, head_dim=128,
                rope_theta=500000.0, max_position_embeddings=8192,
                rms_norm_eps=1e-5,
            ),
            "mistral-7b": dict(
                name="mistral-7b", vocab_size=32000, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                rope_theta=10000.0, max_position_embeddings=32768,
                sliding_window=4096, rms_norm_eps=1e-5,
            ),
            "qwen2.5-7b": dict(
                name="qwen2.5-7b", vocab_size=152064, hidden_size=3584,
                intermediate_size=18944, num_hidden_layers=28,
                num_attention_heads=28, num_key_value_heads=4, head_dim=128,
                rope_theta=1000000.0, max_position_embeddings=32768,
                rms_norm_eps=1e-6, attention_bias=True,
            ),
            "gemma2-9b": dict(
                name="gemma2-9b", vocab_size=256000, hidden_size=3584,
                intermediate_size=14336, num_hidden_layers=42,
                num_attention_heads=16, num_key_value_heads=8, head_dim=256,
                rope_theta=10000.0, max_position_embeddings=8192,
                rms_norm_eps=1e-6, tie_word_embeddings=True,
                sliding_window=4096, hidden_act="gelu_tanh",
                query_pre_attn_scalar=256.0, attn_logit_softcapping=50.0,
                final_logit_softcapping=30.0, rmsnorm_unit_offset=True,
                scale_embeddings=True, post_block_norms=True,
                layer_types=tuple(
                    "sliding_attention" if (i + 1) % 2 else "full_attention"
                    for i in range(42)
                ),
            ),
            "mixtral-8x7b": dict(
                name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
                intermediate_size=14336, num_hidden_layers=32,
                num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                rope_theta=1000000.0, max_position_embeddings=32768,
                rms_norm_eps=1e-5, num_local_experts=8,
                num_experts_per_tok=2,
            ),
        }
        base = dict(presets[name])
        base.update(overrides)
        return ModelSpec(**base)

    @staticmethod
    def tiny(**overrides) -> "ModelSpec":
        """A small spec for unit tests."""
        base = dict(
            name="tiny",
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=4,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            rope_theta=10000.0,
            max_position_embeddings=2048,
        )
        base.update(overrides)
        return ModelSpec(**base)


# ---------------------------------------------------------------------------
# Compression policy configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CompressionSpec:
    """Hyper-parameters of the KV-cache compression policy.

    Defaults follow the LongBench runner's injected values (window 8,
    kernel 7, maxpool — run_longbench.py:219-261), not the
    lazy ``init_*`` fallbacks.
    """

    method: str = "fullkv"
    #: Per-layer KV budget at the end of prefill (``max_capacity_prompt``).
    max_capacity_prompt: int = 2048
    #: Optional explicit per-layer capacity schedule (the reference accepts
    #: per-layer lists on each attention module's config,
    #: run_longbench.py:242-252).  Overrides ``max_capacity_prompt`` for the
    #: single-budget methods; length must equal num_hidden_layers.
    layer_capacity: "Optional[Tuple[int, ...]]" = None
    #: Observation window (last ``window_size`` queries score the keys).
    window_size: int = 8
    #: 1-D pooling kernel over the raw score vector.
    kernel_size: int = 7
    pooling: str = "maxpool"  # "avgpool" | "maxpool"
    #: PyramidKV budget-slope hyper-parameter (pyramidkv_utils.py:174).
    beta: int = 20
    #: L2Norm: layers whose cache is never compressed (pyramidkv_utils.py:962).
    skip_layers: Tuple[int, ...] = (0, 1)
    #: LOOK-M merging of evicted KVs: None | "pivot".
    merge: Optional[str] = None
    #: AdaKV floor ratio (guaranteed fraction of the base budget per head).
    floor_ratio: float = 0.2
    #: AdaKV score-mass normalisation toggle (pyramidkv_utils.py:709-711).
    normalize: bool = True
    #: Static bound on any single head's budget as a multiple of the base
    #: budget (AdaKV).  The reference's ragged cache has no bound; a static
    #: TPU cache needs one.  Overflow above the bound is redistributed.
    adakv_head_capacity_mult: float = 2.0
    #: HeadKV static per-head capacities, shape [layers, heads] (nested
    #: tuples so the spec stays hashable); computed from heads_score priors
    #: (run_longbench.py:225-234).
    head_capacity: Optional[Tuple[Tuple[int, ...], ...]] = None
    #: ThinK key-channel pruning ratio + protected recent size
    #: (pyramidkv_utils.py:13-26; run_longbench.py:353-354).
    pruning_ratio: float = 0.4
    recent_size: int = 32
    #: ThinK storage: False (default) stores the pruned-region keys at
    #: ``head_dim - int(head_dim*ratio)`` channels (the reference's
    #: ``cache_utils_think`` narrow layout, :390-424 — the method's whole
    #: memory benefit); True keeps a full-width key buffer with dropped
    #: channels zeroed (bit-identical dot products; used as the oracle and
    #: automatically selected when ``quant_method`` is set).  The narrow
    #: layout prunes every row; the reference's ``q_len < cap`` early-out
    #: (no pruning for short prompts) only survives in the dense layout.
    think_dense: bool = False
    #: CAM start-budget ratio (pyramidkv_utils.py:432).
    start_budget_ratio: float = 0.1
    #: MInference vertical_and_slash pattern sizes (minference.py:9-12 loads
    #: per-model configs; these are the engine-level knobs).
    minference_vertical_size: int = 1000
    minference_slash_size: int = 200
    minference_last_q: int = 64
    #: Block-sparse slash coverage: k-tiles (of 256 by default) attended
    #: per q-block (the TPU analogue of MInference's block-granular Triton
    #: kernel).  Coverage width = tile_budget * k_tile columns.
    minference_tile_budget: int = 8
    #: Slash-coverage kernel: "grid" = one grid step per visited tile
    #: (scalar-prefetched index maps), "db" = double-buffered manual-DMA
    #: variant (tile loop inside the kernel, invalid tiles skipped).
    minference_slash_impl: str = "grid"
    #: Per-layer/per-head offline pattern budgets — the engine analogue of
    #: the reference's MODEL2PATH JSON (minference.py:9-12).  A nested
    #: tuple ``[num_layers][num_heads] of (vertical, slash)`` produced by
    #: :func:`load_minference_pattern_config`; ``None`` keeps the uniform
    #: ``minference_vertical_size/slash_size`` online estimate.
    minference_pattern_config: "tuple | None" = None
    #: Below this prompt bucket the engine runs EXACT dense flash attention
    #: instead of the sparse pattern (dense is strictly more accurate; the
    #: default is the TPU crossover the JAX package measured).  Set 0 to
    #: force the sparse path everywhere.
    minference_dense_below: int = 32768
    #: Aggregate selection over GQA groups and store num_kv_heads entries
    #: instead of the reference's per-query-head selection after repeat_kv
    #: (llama_model.py:158-159).  Saves group_size x cache memory at a small
    #: accuracy delta; off by default for parity.
    gqa_aggregate: bool = False

    # --- KV quantization (KIVI / KVQuant; run_longbench.py:277-288) -------
    quant_method: Optional[str] = None  # None | "kivi" | "kvquant"
    nbits: int = 8  # 8 | 4 | 2
    q_group_size: int = 64
    #: quant-group layout: "group" = HQQ-style group-64 on the KIVI axes
    #: (reference parity: run_longbench.py:287); "pa" = per-axis (one K
    #: scale per channel across all slots, one V scale per token across
    #: all channels — the KIVI paper's axes).  "pa" folds dequantization
    #: into the attention algebra at decode (ops/quant.py::
    #: quant_region_attention_fused): no dequantized copy is ever
    #: materialised, so long-region decode runs at packed-code bandwidth.
    #: Coarser scales than group-64 — measure accuracy before shipping.
    q_layout: str = "group"
    residual_length: int = 128
    outlier_threshold: float = 6.0  # KVQuant outlier extraction (quantcache.py:13)

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one of {METHODS}")
        if self.pooling not in ("avgpool", "maxpool"):
            raise ValueError(f"pooling must be avgpool|maxpool, got {self.pooling!r}")
        if self.method not in ("fullkv", "l2norm", "minference"):
            if self.max_capacity_prompt - self.window_size <= 0:
                raise ValueError(
                    "max_capacity_prompt must exceed window_size "
                    f"({self.max_capacity_prompt} vs {self.window_size})"
                )
        if self.quant_method not in (None, "kivi", "kvquant"):
            raise ValueError(f"quant_method must be None|kivi|kvquant, got {self.quant_method!r}")
        if self.quant_method is not None and self.nbits not in (1, 2, 3, 4, 8):
            raise ValueError(f"nbits must be in (1,2,3,4,8), got {self.nbits}")
        if self.q_layout not in ("group", "pa"):
            raise ValueError(f"q_layout must be group|pa, got {self.q_layout!r}")
        if self.q_layout == "pa" and self.quant_method == "kvquant":
            raise ValueError(
                "q_layout='pa' supports kivi only (kvquant outlier sidecars "
                "keep the grouped dequant paths)")
        if self.merge not in (None, "pivot"):
            raise ValueError(f"merge must be None|'pivot', got {self.merge!r}")

    @property
    def uses_window_scores(self) -> bool:
        return self.method in WINDOW_SCORE_METHODS

    def streaming_window(self) -> int:
        """StreamingLLM uses capacity-4 as its recency window
        (run_longbench.py:222-223)."""
        return self.max_capacity_prompt - 4


# ---------------------------------------------------------------------------
# Budget schedules (all resolved ahead of compilation)
# ---------------------------------------------------------------------------


def pyramid_layer_budgets(
    spec: CompressionSpec, num_layers: int, q_len: int
) -> Tuple[int, ...]:
    """Exact PyramidKV per-layer past-token budgets (before adding the window).

    Reproduces the arithmetic of PyramidKVCluster.update_kv
    (pyramidkv/pyramidkv_utils.py:205-215): lower layers keep
    more, the slope set by ``beta``; clamped when the prompt is short.

    Returns the number of *past* (non-window) tokens layer ``l`` keeps when
    ``q_len >= 2*(cap - w)``.  Callers handle the two short-prompt regimes
    (no compression / uniform budget) separately, as the reference does at
    pyramidkv_utils.py:218-251.
    """
    cap, w = spec.max_capacity_prompt, spec.window_size
    min_num = (cap - w) // spec.beta
    max_num = (cap - w) * 2 - min_num
    if max_num >= q_len - w:
        max_num = q_len - w
        min_num = (cap - w) * 2 - max_num
    steps = (max_num - min_num) // max(num_layers - 1, 1)
    return tuple(max_num - l * steps for l in range(num_layers))


def headkv_capacity_from_scores(
    head_scores: "list[float]",
    num_layers: int,
    num_heads: int,
    max_capacity_prompt: int,
    head_beta: float = 1.01,
) -> Tuple[Tuple[int, ...], ...]:
    """HeadKV per-(layer, head) budgets from retrieval-head importance scores.

    Reproduces run_longbench.py:225-234: normalise the flat score list, scale
    by the total pool capacity, add the uniform floor, round.
    """
    total = float(sum(head_scores))
    norm = [s / total for s in head_scores]
    pool = (max_capacity_prompt // head_beta) * num_layers * num_heads
    min_num = max_capacity_prompt - max_capacity_prompt // head_beta
    caps = []
    it = iter(norm)
    for _ in range(num_layers):
        row = []
        for _ in range(num_heads):
            row.append(int(round(next(it) * pool + min_num)))
        caps.append(tuple(row))
    return tuple(caps)


def load_headkv_scores(path: str) -> "list[float]":
    """Load a heads_score JSON (mean over each head's score list), matching
    run_longbench.py:226-229."""
    with open(path) as f:
        head_list = json.loads(f.readline())
    return [float(sum(v[1]) / len(v[1])) for v in head_list.items()]


# ---------------------------------------------------------------------------
# Engine configuration
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class EngineSpec:
    """Runtime configuration: batching, buckets, dtype, sharding axes."""

    batch_size: int = 1
    max_new_tokens: int = 512
    #: Prompts are left-padded up to the smallest bucket that fits; each
    #: bucket compiles once.  32768 covers the reference's Mistral LongBench
    #: grid (31,500-token contexts, run_longbench.py:75-81) on one chip —
    #: prefill memory is linear in N (per-layer transients only; K/V are
    #: compressed inside the layer scan).
    prefill_buckets: Tuple[int, ...] = (
        512, 1024, 2048, 4096, 8192, 16384, 32768,
    )
    dtype: str = "bfloat16"
    #: Mesh axis sizes: data-parallel x model(head)-parallel.
    mesh_shape: Tuple[int, int] = (1, 1)
    mesh_axis_names: Tuple[str, str] = ("data", "model")
    #: Use the fused prefill/decode kernels (in the port: the CUDA kernels,
    #: which run on CUDA tensors; CPU tensors take their plain versions).
    use_pallas: bool = True
    #: Opt-in: fused dequant-attention decode kernel for KIVI caches (kept
    #: off by default by the JAX package, which measured it slower).
    use_quant_kernel: bool = False
    #: Opt-in: TILED fused dequant-attention kernel for LONG KIVI regions
    #: (grid over slot tiles; a counterfactual in the JAX package).
    use_quant_tiled: bool = False
    #: Force the factored dequant-attention (ops/quant.py::
    #: quant_region_attention_fused) even when a counterfactual knob below
    #: is set.  It is already the default for every KIVI region (scales
    #: fold into query/probabilities so no dequantized copy is
    #: materialised).
    use_quant_fused: bool = False
    #: Opt-in: the STREAMING factored-dequant Pallas kernel for pa-layout
    #: KIVI regions (kernels/quant_fused_decode.py) — unpack + online
    #: softmax + PV stay in VMEM so the region's per-step HBM traffic is
    #: the packed codes alone (the XLA factored path still materialises
    #: each unpacked bf16 bit plane, ~2x the code bytes at int4).
    use_quant_fused_kernel: bool = False
    #: Counterfactual: the older dispatch — chunked dequant scan for long
    #: grouped KIVI regions, one-shot dequant for short.
    use_quant_scan: bool = False
    #: Chunk size for blockwise prefill attention / H2O score accumulation.
    prefill_block: int = 512
    #: Flash-prefill software pipelining: split each fetched k/v block into
    #: this many sub-tiles whose logit dots are all issued before any
    #: online-softmax update (MXU computes sub-tile j+1 while the VPU
    #: updates sub-tile j).  1 = original single-dot body.  When > 1 the
    #: engine fetches ``max(prefill_block, 1024)``-wide k/v blocks with
    #: block_q = fetched/sub_k (>= 512) to keep the fp32 logit sub-tiles
    #: inside scoped VMEM.
    prefill_sub_k: int = 1
    #: Flash-prefill two-pass schedule (exp-avoidance experiment): pass A
    #: computes row maxes only, pass B accumulates
    #: rescale-free against them — the per-tile online-softmax
    #: bookkeeping (running max, alpha exp, accumulator rescale, m/l
    #: stores) disappears at the cost of a second QK sweep.
    prefill_two_pass: bool = False
    #: Chunked prefill (models/chunked_prefill.py): run the prompt forward
    #: in fixed-size token chunks so serving refills interleave with decode
    #: quanta at chunk granularity instead of stalling whole prompts.
    #: ``None`` keeps the monolithic one-call prefill.  Must divide every
    #: prefill bucket; methods outside `chunked_prefill.supports_chunked`
    #: fall back to monolithic.
    prefill_chunk: "int | None" = None
    greedy: bool = True
    temperature: float = 1.0
    #: top-k restriction for sampling (None = full softmax); ignored when
    #: ``greedy`` (the reference decodes greedily everywhere).
    sample_top_k: "int | None" = None
    #: Speculative decoding: "ngram" enables on-device prompt-lookup
    #: drafting + multi-token verification (`ops/ngram.py`,
    #: `models/llama.py::verify_step`).  Greedy, B=1, plain bf16 cache
    #: paths only — other configs silently fall back to the one-token
    #: loop.  Decode reads the full weight set per step, so verifying
    #: ``spec_draft_len`` draft tokens costs ~one step; accepted drafts
    #: are nearly free throughput (long-context QA/summarisation copies
    #: prompt spans, which the n-gram match finds).
    speculative: "str | None" = None
    #: trailing n-gram width matched against the history.
    spec_ngram: int = 3
    #: max draft tokens proposed (and verified) per iteration.
    spec_draft_len: int = 8
    #: ContinuousBatcher guard: speculation auto-disables above this many
    #: lanes (with a logged warning): a verify forward over lanes x (k+1)
    #: rows leaves the weight-bandwidth-bound regime.
    spec_max_lanes: int = 4

    def __post_init__(self):
        if self.prefill_sub_k < 1:
            raise ValueError(
                f"prefill_sub_k must be >= 1, got {self.prefill_sub_k}")
        if self.prefill_block < 1:
            raise ValueError(
                f"prefill_block must be >= 1, got {self.prefill_block}")

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return _round_up(length, self.prefill_buckets[-1])


def load_minference_pattern_config(path: str, num_layers: int,
                                   num_heads: int) -> tuple:
    """Parse a MInference per-model pattern config into the static nested
    tuple ``CompressionSpec.minference_pattern_config`` expects.

    The file format is the MInference repo's MODEL2PATH JSON (the
    reference loads it verbatim, pyramidkv/minference.py:
    9-12): a list with one dict per layer mapping head index (string) ->
    ``[pattern_name, [arg0, arg1]]``.  ``vertical_and_slash`` maps
    directly to (vertical, slash); other pattern names (``stream_llm``,
    ``block_sparse``) are approximated as vertical+slash with their two
    budget args (documented divergence — our attention engine expresses
    ONE pattern family; the offline budgets still steer per-head
    coverage).  Missing layers/heads fall back to the last seen entry.
    """
    import json

    with open(path) as fh:
        raw = json.load(fh)
    out = []
    last = (1000, 200)
    for li in range(num_layers):
        layer = raw[li] if li < len(raw) else {}
        heads = []
        for hi in range(num_heads):
            ent = layer.get(str(hi)) or layer.get(hi)
            if ent:
                args = ent[1]
                last = (int(args[0]), int(args[1]))
            heads.append(last)
        out.append(tuple(heads))
    return tuple(out)

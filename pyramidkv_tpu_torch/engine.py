"""Generation engine (counterpart of ``pyramidkv_tpu/engine.py``):
bucketed prefill with compression, then greedy decode over the compressed
cache.

Prompts are left-padded to the smallest bucket that fits; the whole batch
runs one monolithic prefill (``models.llama.prefill``), or with
``EngineSpec.prefill_chunk`` a chunked one (``models/chunked_prefill.py``,
a Python loop over the chunks, H2O's run twice) where the plan supports
it, and a Python decode loop of ``models.llama.decode_step`` with the JAX
loop's ``done`` / ``-1`` / EOS semantics.  The loop reads ``done`` back
each step (one host sync per token); capturing the step in a CUDA graph is
later work (ROADMAP).

Ported: greedy decoding, ``fullkv`` / ``snapkv`` / ``pyramidkv`` / ``h2o`` /
``minference`` (vertical-and-slash sparse prefill, fullkv cache), with bf16
or quantized weights (``models/weights.py``: int8, packed int4 per channel
or per group, fused or not), a bf16 or KIVI cache (``quant_method=
"kivi"``: 8/4/2 bits, group or pa layout; KVQuant raises), monolithic or
chunked prefill.  Sampling, ``prefix`` handles and speculative decoding
raise ``NotImplementedError`` (ROADMAP queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .cache import cache_memory_bytes
from .config import CompressionSpec, EngineSpec, ModelSpec
from .models import chunked_prefill as cp
from .models import llama
from .models.weights import QuantW
from .policy import PolicyPlan, make_plan


@dataclass
class GenerationOutput:
    #: [B] generated token-id lists (EOS excluded).
    tokens: "list[list[int]]"
    prefill_seconds: float
    decode_seconds: float
    decode_steps: int
    kv_cache_bytes: int


@dataclass
class EngineStats:
    """Cumulative engine counters."""

    requests: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    kv_cache_bytes_last: int = 0

    def decode_tokens_per_second(self) -> float:
        return (self.generated_tokens / self.decode_seconds
                if self.decode_seconds else 0.0)

    def prefill_tokens_per_second(self) -> float:
        return (self.prompt_tokens / self.prefill_seconds
                if self.prefill_seconds else 0.0)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantW):
        return QuantW(*(t.to(device) for t in tree))
    return tree.to(device)


class Engine:
    """Single-model generation engine with KV compression.

    ``device=None`` means the CUDA card, and raises when there is none;
    pass ``device="cpu"`` to run the plain CPU path.  ``params`` (the JAX
    layout, ``models/convert.py``) are moved to ``device`` if needed.
    """

    def __init__(
        self,
        model_spec: ModelSpec,
        comp_spec: CompressionSpec,
        engine_spec: EngineSpec,
        params: dict,
        *,
        device=None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine: no CUDA device; pass device='cpu' for the CPU")
            device = "cuda"
        es = engine_spec
        if not es.greedy or es.speculative:
            raise NotImplementedError(
                "sampling and speculative decoding are not ported yet "
                "(ROADMAP queue 1)")
        if comp_spec.quant_method is not None and (
                es.use_quant_scan
                or (es.use_quant_fused and comp_spec.q_layout == "group")):
            # the port's KIVI decode always runs its region kernels
            # (use_quant_kernel / use_quant_tiled / use_quant_fused_kernel
            # name what it does anyway)
            raise NotImplementedError(
                "the XLA dequantization paths (use_quant_scan, and "
                "use_quant_fused on a group layout) are not ported "
                "(ROADMAP queue 1 #11)")
        llama.check_ported(model_spec)
        self.device = torch.device(device)
        self.model_spec = model_spec
        self.comp_spec = comp_spec
        self.engine_spec = engine_spec
        self.params = _to_device(params, self.device)
        #: "kernel": the CUDA kernels (plain versions for CPU tensors)
        self.attention_impl = "kernel" if es.use_pallas else "plain"
        self.stats = EngineStats()
        self.plan_for(es.prefill_buckets[0])  # unported methods raise here

    def plan_for(self, bucket: int) -> PolicyPlan:
        return make_plan(self.comp_spec, self.model_spec.num_hidden_layers,
                         bucket, self.engine_spec.max_new_tokens)

    def chunked_prefill_supported(self, bucket: int) -> bool:
        """True when ``generate`` prefills this bucket in chunks: a
        ``prefill_chunk`` dividing the bucket, no wider window than the
        chunk, and a plan one of the two carries takes."""
        c = self.engine_spec.prefill_chunk
        if c is None or bucket % c != 0:
            return False
        plan = self.plan_for(bucket)
        return plan.window <= c and (cp.supports_chunked(plan)
                                     or cp.supports_chunked_quant(plan, c))

    def _run_chunked_prefill(self, bucket: int, tokens: torch.Tensor,
                             true_len: torch.Tensor):
        """Every chunk of the bucket, then the finish: (logits, cache).  H2O
        runs the chunks twice (the second pass accumulates its scores)."""
        plan = self.plan_for(bucket)
        c = self.engine_spec.prefill_chunk
        b = tokens.shape[0]
        spec, p, impl = self.model_spec, self.params, self.attention_impl
        chunks = range(bucket // c)
        if cp.supports_chunked_quant(plan, c):
            state = cp.init_quant_state(spec, plan, b, c, self.device)
            for i in chunks:
                hidden = cp.prefill_chunk_quant(
                    p, spec, plan, state, tokens[:, i * c:(i + 1) * c],
                    true_len, i * c, attention_impl=impl)
            return cp.prefill_finish_quant(p, spec, plan, state, hidden,
                                           true_len, c, attention_impl=impl)
        state = cp.init_state(spec, plan, b, p["final_norm"].dtype,
                              self.device)
        acc = (cp.init_h2o_scores(spec, plan, b, self.device)
               if cp.needs_score_pass(plan) else None)
        passes = [None] if acc is None else [None, acc]
        for score_acc in passes:
            for i in chunks:
                window_q, hidden = cp.prefill_chunk(
                    p, spec, plan, state, tokens[:, i * c:(i + 1) * c],
                    true_len, chunk_start=i * c, attention_impl=impl,
                    score_acc=score_acc)
        return cp.prefill_finish(p, spec, plan, state, window_q, hidden,
                                 true_len, attention_impl=impl,
                                 h2o_raw_scores=acc)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(
        self,
        prompt_ids: Sequence[Sequence[int]],
        *,
        max_new_tokens: Optional[int] = None,
        eos_token_ids: Sequence[int] = (),
        prefix=None,
    ) -> GenerationOutput:
        """Greedy generation for a batch of prompts (token ids).

        ``max_new_tokens`` must be <= ``engine_spec.max_new_tokens`` (the
        decode-slot allocation).  EOS is suppressed for the first token."""
        if prefix is not None:
            raise NotImplementedError(
                "prefix handles are not ported yet (ROADMAP queue 1)")
        es = self.engine_spec
        max_new = max_new_tokens or es.max_new_tokens
        assert max_new <= es.max_new_tokens
        dev = self.device
        b = len(prompt_ids)
        lens = [len(p) for p in prompt_ids]
        bucket = es.bucket_for(max(lens))
        plan = self.plan_for(bucket)
        tokens = np.zeros((b, bucket), dtype=np.int64)
        for i, p in enumerate(prompt_ids):
            tokens[i, bucket - len(p):] = np.asarray(p, dtype=np.int64)
        tokens = torch.from_numpy(tokens).to(dev)
        true_len = torch.tensor(lens, dtype=torch.int32, device=dev)

        t0 = time.perf_counter()
        if self.chunked_prefill_supported(bucket):
            logits, cache = self._run_chunked_prefill(bucket, tokens,
                                                      true_len)
        else:
            logits, cache = llama.prefill(self.params, self.model_spec, plan,
                                          tokens, true_len,
                                          attention_impl=self.attention_impl)
        if eos_token_ids:
            # min_length = context + 1: at least one real token
            logits[:, list(eos_token_ids)] = float("-inf")
        first = logits.argmax(dim=-1)
        self._sync()
        t1 = time.perf_counter()

        eos = torch.tensor(list(eos_token_ids) or [-1], device=dev)
        out = torch.zeros((b, es.max_new_tokens), dtype=torch.int64,
                          device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        limit = min(max_new - 1, es.max_new_tokens)
        token, steps = first, 0
        while steps < limit and not bool(done.all()):
            logits, cache = llama.decode_step(
                self.params, self.model_spec, plan, cache, token,
                attention_impl=self.attention_impl)
            nxt = logits.argmax(dim=-1)
            is_eos = (nxt[:, None] == eos[None, :]).any(dim=-1)
            # after EOS keep feeding the last token; its output slot is -1
            nxt = torch.where(done, token, nxt)
            out[:, steps] = torch.where(done, -1, nxt)
            done = done | is_eos
            token = nxt
            steps += 1
        out = out.cpu().numpy()
        first_np = first.cpu().numpy()
        self._sync()
        t2 = time.perf_counter()

        results = []
        eos_set = set(int(e) for e in eos_token_ids)
        for i in range(b):
            seq = [int(first_np[i])]
            if seq[0] in eos_set:
                seq = []
            else:
                for t in out[i, : max_new - 1]:
                    t = int(t)
                    if t < 0 or t in eos_set:
                        break
                    seq.append(t)
            results.append(seq[:max_new])
        kv_bytes = cache_memory_bytes(cache)
        self.stats.requests += b
        self.stats.prompt_tokens += sum(lens)
        self.stats.generated_tokens += sum(len(r) for r in results)
        self.stats.prefill_seconds += t1 - t0
        self.stats.decode_seconds += t2 - t1
        self.stats.kv_cache_bytes_last = kv_bytes
        return GenerationOutput(tokens=results, prefill_seconds=t1 - t0,
                                decode_seconds=t2 - t1, decode_steps=steps,
                                kv_cache_bytes=kv_bytes)

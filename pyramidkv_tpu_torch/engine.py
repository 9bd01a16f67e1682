"""Generation engine (counterpart of ``pyramidkv_tpu/engine.py``):
bucketed prefill with compression, then greedy decode over the compressed
cache.

Prompts are left-padded to the smallest bucket that fits; the whole batch
runs one monolithic prefill (``models.llama.prefill``, one-pass or
two-pass flash), or with ``EngineSpec.prefill_chunk`` a chunked one
(``models/chunked_prefill.py``, a Python loop over the chunks, H2O's run
twice) where the plan supports it, and a Python decode loop of
``models.llama.decode_step`` with the JAX loop's ``done`` / ``-1`` / EOS
semantics.  The loop reads ``done`` back each step (one host sync per
token); capturing the step in a CUDA graph is later work (ROADMAP).

Prefix caching rides the chunked prefill: :meth:`Engine.precompute_prefix`
runs a shared prompt prefix's chunks once into a :class:`PrefixHandle`
(the bf16 carry's K/V, or the fullkv + KIVI quantized carry), and
``generate(prefix=handle)`` resumes each request from it, skipping the
chunks the handle covers; :class:`PrefixRegistry` keeps handles by prefix,
LRU.

Ported: greedy decoding on Llama-family models, Mistral's uniform sliding
window, Qwen2's QKV biases and Gemma-2 (its alternating window, softcaps,
head dim 256 and other features; every cache below runs there, the KIVI
region kernels and the quantized carry with its scale, cap and per-layer
windows), with every compression method of ``config.METHODS``
(``policy.py``: the single-budget, pyramid, position, norm, random,
head-budget, merging and ThinK methods, ``gqa_aggregate``, per-layer
capacities; ``minference``'s vertical-and-slash sparse prefill), with bf16
or quantized weights (``models/weights.py``: int8, packed int4 per channel
or per group, fused or not), a bf16 or KIVI cache (``quant_method=
"kivi"``: 8/4/2 bits, group or pa layout, the default factored route or
the opt-in f32 one, with ``PKV_QUANT_MM_BF16=1`` on the tiled route the
tiled kernel's ``mm_bf16`` where the JAX engine takes it; KVQuant raises),
monolithic or chunked prefill, prefix handles.  ``generate(rng_seed=...)``
seeds the random methods with JAX's bits (``prng.py``).  Sampling and
speculative decoding raise ``NotImplementedError`` (ROADMAP queue 1); serving
(continuous batching, automatic prefix matching) is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import prng
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


#: the npz dtype strings of a handle's leaves (numpy's names, which the JAX
#: package writes; bfloat16 is read as torch.bfloat16, without ml_dtypes)
_NPZ_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}


@dataclass(frozen=True)
class PrefixHandle:
    """Precomputed chunked-prefill state of a shared prompt prefix
    (JAX ``engine.py::PrefixHandle``).

    RoPE positions are ``slot - pad``, so the prefix tokens carry positions
    [0, P) in every request whatever its padding, and prefix rows attend
    only to prefix rows: the cached K/V do not depend on the request's
    alignment.  Per request they go to slot offset ``pad`` and the
    remaining chunks run (the chunk straddling the prefix end is
    recomputed).  H2O caches its first pass only (the score pass reads the
    whole K buffer and always reruns).  fullkv + KIVI plans (the quantized
    carry) get a quantized handle: the prefix's own chunk-local carry,
    requantized on the request's chunk grid at resume
    (``models.chunked_prefill.quant_state_from_prefix``).
    """

    #: the full prefix token ids (requests must start with these)
    token_ids: "tuple[int, ...]"
    #: cached columns: ``len(token_ids)`` rounded down to the chunk
    full_len: int
    chunk_len: int
    #: ChunkState with k/v [L, 1, KV, full_len, D], or for fullkv + KIVI
    #: plans the prefix's QuantChunkState; CPU tensors for a host handle
    state: object
    #: quantized handles only: the handle's own bit width when narrower
    #: than the plan's; None = the plan's
    nbits: Optional[int] = None

    @property
    def is_quant(self) -> bool:
        return isinstance(self.state, cp.QuantChunkState)

    @property
    def kv_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.state)

    @staticmethod
    def _npz_path(path: str) -> str:
        # np.savez appends '.npz' when absent: save('x') and load('x') agree
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        """Write the handle as JAX's ``PrefixHandle.save`` does (npz: each
        leaf as uint8 bytes with its shape and numpy dtype name), so either
        package loads what the other saved."""
        payload = {
            "token_ids": np.asarray(self.token_ids, np.int64),
            "full_len": np.int64(self.full_len),
            "chunk_len": np.int64(self.chunk_len),
            "nbits": np.int64(self.nbits or 0),
            "fields": np.bytes_(",".join(self.state._fields).encode()),
        }
        names = {v: k for k, v in _NPZ_DTYPES.items()}
        for name in self.state._fields:
            t = getattr(self.state, name).detach().cpu().contiguous()
            payload[f"arr_{name}"] = t.view(torch.uint8).numpy()
            payload[f"shape_{name}"] = np.asarray(t.shape, np.int64)
            payload[f"dtype_{name}"] = np.bytes_(names[t.dtype].encode())
        np.savez(self._npz_path(path), **payload)

    @classmethod
    def load(cls, path: str, *, device=None) -> "PrefixHandle":
        """Read a handle either package saved, its leaves on ``device``
        (None: the CUDA card; ``"cpu"`` gives a host handle)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("PrefixHandle.load: no CUDA device; pass "
                                   "device='cpu' for the CPU")
            device = "cuda"
        with np.load(cls._npz_path(path)) as z:
            names = bytes(z["fields"]).decode().split(",")

            def arr(name):
                dt = _NPZ_DTYPES[bytes(z[f"dtype_{name}"]).decode()]
                shape = tuple(int(s) for s in z[f"shape_{name}"])
                raw = torch.from_numpy(np.ascontiguousarray(z[f"arr_{name}"]))
                return raw.view(dt).reshape(shape).to(device)

            klass = (cp.ChunkState
                     if set(names) == set(cp.ChunkState._fields)
                     else cp.QuantChunkState)
            return cls(
                token_ids=tuple(int(t) for t in z["token_ids"]),
                full_len=int(z["full_len"]), chunk_len=int(z["chunk_len"]),
                state=klass(**{n: arr(n) for n in names}),
                nbits=(int(z["nbits"]) or None) if "nbits" in z else None)


class PrefixRegistry:
    """LRU registry of :class:`PrefixHandle` snapshots keyed by the prefix
    token tuple (JAX ``engine.py::PrefixRegistry``).

    ``get`` builds on a miss; ``match`` returns the longest registered
    prefix a prompt starts with.  Eviction is LRU by entries and, when
    ``max_bytes`` is set, by total handle bytes (the newest entry always
    survives).  ``host`` and ``handle_nbits`` are the defaults of the
    handles ``get`` builds (``Engine.precompute_prefix``)."""

    def __init__(self, engine: "Engine", max_entries: int = 8,
                 max_bytes: Optional[int] = None, host: bool = False,
                 handle_nbits: Optional[int] = None):
        self.engine = engine
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.host = host
        self.handle_nbits = handle_nbits
        self._entries: "OrderedDict[tuple, PrefixHandle]" = OrderedDict()

    @property
    def bytes(self) -> int:
        return sum(h.kv_bytes for h in self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, prefix_ids: Sequence[int],
            host: Optional[bool] = None) -> PrefixHandle:
        key = tuple(int(t) for t in prefix_ids)
        h = self._entries.get(key)
        if h is None:
            h = self.engine.precompute_prefix(
                key, host=self.host if host is None else host,
                handle_nbits=self.handle_nbits)
            self._entries[key] = h
            self._evict()
        else:
            self._entries.move_to_end(key)
        return h

    def put(self, handle: PrefixHandle) -> None:
        """Register a handle built or loaded elsewhere."""
        self._entries[handle.token_ids] = handle
        self._entries.move_to_end(handle.token_ids)
        self._evict()

    def match(self, prompt_ids: Sequence[int]) -> Optional[PrefixHandle]:
        p = tuple(int(t) for t in prompt_ids)
        best = None
        for key in self._entries:
            if len(key) <= len(p) and p[:len(key)] == key and (
                    best is None or len(key) > len(best)):
                best = key
        if best is None:
            return None
        self._entries.move_to_end(best)
        return self._entries[best]

    def _evict(self) -> None:
        while len(self._entries) > max(self.max_entries, 1):
            self._entries.popitem(last=False)
        if self.max_bytes is not None:
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                self._entries.popitem(last=False)


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
        if comp_spec.quant_method is not None and es.use_quant_scan:
            raise NotImplementedError(
                "the chunked dequantization scan (use_quant_scan) is not "
                "ported (ROADMAP queue 1 #6)")
        llama.check_ported(model_spec)
        self.device = torch.device(device)
        self.model_spec = model_spec
        self.comp_spec = comp_spec
        self.engine_spec = engine_spec
        self.params = _to_device(params, self.device)
        #: "kernel": the CUDA kernels (plain versions for CPU tensors)
        self.attention_impl = "kernel" if es.use_pallas else "plain"
        #: group-layout KIVI regions decode through the f32 kernels (JAX's
        #: opt-in counterfactuals) instead of the default factored
        #: dequantization, as the JAX engine routes them; in the tiled
        #: kernel's mm_bf16 mode where ``llama.region_mm_bf16`` says (per
        #: region length, at decode)
        self.f32_quant = ((es.use_quant_kernel or es.use_quant_tiled)
                          and not es.use_quant_fused)
        self.stats = EngineStats()
        self.plan_for(es.prefill_buckets[0])  # unported options raise here

    def plan_for(self, bucket: int) -> PolicyPlan:
        # the scorers mirror the model's attention (Gemma-2's scale and
        # cap; JAX engine.py:315-317)
        akw = llama.attn_args(self.model_spec)
        return make_plan(self.comp_spec, self.model_spec.num_hidden_layers,
                         bucket, self.engine_spec.max_new_tokens,
                         attn_scale=akw["scale"], attn_softcap=akw["softcap"])

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
                             true_len: torch.Tensor,
                             prefix: Optional[PrefixHandle] = None,
                             lens: Optional[Sequence[int]] = None,
                             rng: Optional[torch.Tensor] = None):
        """Every chunk of the bucket, then the finish: (logits, cache).  H2O
        runs the chunks twice (the second pass accumulates its scores).
        With a ``prefix`` handle the carry starts from the handle
        (:meth:`_apply_prefix`) and the chunks it covers are skipped (H2O's
        second pass, with a fresh score accumulator, reruns them all)."""
        plan = self.plan_for(bucket)
        c = self.engine_spec.prefill_chunk
        b = tokens.shape[0]
        spec, p, impl = self.model_spec, self.params, self.attention_impl
        state, k0 = (self._apply_prefix(bucket, b, prefix, lens)
                     if prefix is not None else (None, 0))
        chunks = range(bucket // c)
        if cp.supports_chunked_quant(plan, c):
            if state is None:
                state = cp.init_quant_state(spec, plan, b, c, self.device)
            for i in chunks[k0:]:
                hidden = cp.prefill_chunk_quant(
                    p, spec, plan, state, tokens[:, i * c:(i + 1) * c],
                    true_len, i * c, attention_impl=impl)
            return cp.prefill_finish_quant(p, spec, plan, state, hidden,
                                           true_len, c, attention_impl=impl)
        if state is None:
            state = cp.init_state(spec, plan, b, p["final_norm"].dtype,
                                  self.device)
        acc = (cp.init_h2o_scores(spec, plan, b, self.device)
               if cp.needs_score_pass(plan) else None)
        passes = [(None, k0)] if acc is None else [(None, k0), (acc, 0)]
        for score_acc, first in passes:
            for i in chunks[first:]:
                window_q, hidden = cp.prefill_chunk(
                    p, spec, plan, state, tokens[:, i * c:(i + 1) * c],
                    true_len, chunk_start=i * c, attention_impl=impl,
                    score_acc=score_acc)
        return cp.prefill_finish(p, spec, plan, state, window_q, hidden,
                                 true_len, attention_impl=impl,
                                 h2o_raw_scores=acc, rng=rng)

    # -- prefix caching ----------------------------------------------------

    def prefix_cache_supported(self, bucket: Optional[int] = None) -> bool:
        """Prefix caching rides the chunk carry: bf16-carry plans get a bf16
        handle, fullkv + KIVI quantized-carry plans a quantized one."""
        return self.chunked_prefill_supported(
            bucket or self.engine_spec.prefill_buckets[0])

    def precompute_prefix(self, prefix_ids: Sequence[int],
                          host: bool = False,
                          handle_nbits: Optional[int] = None
                          ) -> PrefixHandle:
        """Run the shared prefix's chunks once (batch 1, no padding, at the
        bucket ``p_full``: the prefix rounded down to the chunk) and return
        the carry as a :class:`PrefixHandle`.  ``host=True`` keeps it as CPU
        tensors, copied to the card by each ``generate`` that resumes from
        it.  ``handle_nbits`` (quantized-carry plans only) encodes the
        handle at fewer bits than the plan's; resume dequantizes at the
        handle's width and requantizes at the plan's."""
        es = self.engine_spec
        c = es.prefill_chunk
        if c is None:
            raise ValueError("prefix caching requires chunked prefill "
                             "(EngineSpec.prefill_chunk)")
        if not self.prefix_cache_supported():
            raise ValueError(
                f"prefix caching unsupported for this plan (method "
                f"{self.comp_spec.method!r}, quant_method "
                f"{self.comp_spec.quant_method!r}): needs a chunked-prefill"
                f" carry (bf16 or the fullkv+KIVI quant carry)")
        plan0 = self.plan_for(es.prefill_buckets[0])
        quant = not cp.supports_chunked(plan0)  # fullkv + KIVI
        if handle_nbits is not None:
            if not quant:
                raise ValueError("handle_nbits needs a quant-carry plan")
            if handle_nbits > plan0.spec.nbits:
                raise ValueError(
                    f"handle_nbits {handle_nbits} wider than the plan's "
                    f"{plan0.spec.nbits} — the handle would not shrink")
            if handle_nbits == plan0.spec.nbits:
                handle_nbits = None
        n = len(prefix_ids)
        p_full = (n // c) * c
        if p_full < c:
            raise ValueError(
                f"prefix ({n} tokens) shorter than one prefill chunk ({c}):"
                f" nothing to cache")
        # the chunk forwards read the carry width and the window of the plan
        plan = dataclasses.replace(plan0, bucket_len=p_full)
        if handle_nbits is not None:
            plan = dataclasses.replace(plan, spec=dataclasses.replace(
                plan.spec, nbits=handle_nbits))
        spec, p, impl = self.model_spec, self.params, self.attention_impl
        toks = torch.tensor([list(prefix_ids[:p_full])], dtype=torch.int64,
                            device=self.device)
        tl = torch.full((1,), p_full, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            if quant:
                state = cp.init_quant_state(spec, plan, 1, c, self.device)
            else:
                state = cp.init_state(spec, plan, 1, p["final_norm"].dtype,
                                      self.device)
            for i in range(p_full // c):
                chunk = toks[:, i * c:(i + 1) * c]
                if quant:
                    cp.prefill_chunk_quant(p, spec, plan, state, chunk, tl,
                                           i * c, attention_impl=impl)
                else:
                    cp.prefill_chunk(p, spec, plan, state, chunk, tl,
                                     chunk_start=i * c, attention_impl=impl)
        self._sync()
        if host:
            state = type(state)(*(x.cpu() for x in state))
        return PrefixHandle(token_ids=tuple(int(t) for t in prefix_ids),
                            full_len=p_full, chunk_len=c, state=state,
                            nbits=handle_nbits)

    def _apply_prefix(self, bucket: int, batch: int, prefix: PrefixHandle,
                      lens: Sequence[int]):
        """The carry with the handle's rows at each row's pad offset, and
        the first chunk to run: (state, k0).  k0 is the first chunk not
        covered by every row's cached span [pad, pad + full_len), clamped
        so the last chunk (which makes the window queries and the last
        hidden row) always runs."""
        c = self.engine_spec.prefill_chunk
        if prefix.chunk_len != c:
            raise ValueError(
                f"prefix handle chunk {prefix.chunk_len} != engine chunk {c}")
        pf = prefix.full_len
        pads = [bucket - int(n) for n in lens]
        plan = self.plan_for(bucket)
        k0 = min((pad + pf) // c for pad in pads)
        k0 = max(0, min(k0, bucket // c - 1))
        quant_plan = (not cp.supports_chunked(plan)
                      and cp.supports_chunked_quant(plan, c))
        if prefix.is_quant != quant_plan:
            raise ValueError(
                f"{'quantized' if prefix.is_quant else 'bf16'} prefix handle "
                f"on a {'non-' if not quant_plan else ''}quant-carry plan")
        # a host handle is copied to the card for this call
        hstate = type(prefix.state)(*(x.to(self.device)
                                      for x in prefix.state))
        if prefix.is_quant:
            return cp.quant_state_from_prefix(
                self.model_spec, plan, hstate, pf, pads, k0, c,
                handle_nbits=prefix.nbits), k0
        dtype = self.params["final_norm"].dtype
        state = cp.init_state(self.model_spec, plan, batch, dtype,
                              self.device)
        for i, pad in enumerate(pads):
            state.k[:, i, :, pad:pad + pf] = hstate.k[:, 0]
            state.v[:, i, :, pad:pad + pf] = hstate.v[:, 0]
        return state, k0

    def _check_prefix(self, prefix: PrefixHandle,
                      prompt_ids: Sequence[Sequence[int]], bucket: int):
        if not self.prefix_cache_supported(bucket):
            raise ValueError(
                f"prefix caching unsupported at bucket {bucket} for this "
                f"plan (needs a chunked-prefill carry)")
        pid = prefix.token_ids
        for p in prompt_ids:
            if len(p) < len(pid) or tuple(
                    int(t) for t in p[:len(pid)]) != pid:
                raise ValueError(
                    "prompt does not start with the prefix handle's tokens")

    def prefix_usable(self, prefix: Optional[PrefixHandle],
                      prompt_ids: Sequence[Sequence[int]],
                      bucket: int) -> bool:
        """:meth:`_check_prefix` without raising."""
        if prefix is None:
            return False
        try:
            self._check_prefix(prefix, prompt_ids, bucket)
        except ValueError:
            return False
        return True

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
        rng_seed: int = 0,
        prefix: Optional[PrefixHandle] = None,
    ) -> GenerationOutput:
        """Greedy generation for a batch of prompts (token ids).

        ``max_new_tokens`` must be <= ``engine_spec.max_new_tokens`` (the
        decode-slot allocation).  EOS is suppressed for the first token.
        ``rng_seed``: the key ``prng.PRNGKey(rng_seed)`` whose per-layer
        split drives random eviction and CAM's draws (JAX's bits).
        ``prefix``: a :meth:`precompute_prefix` handle; every prompt must
        start with its tokens, whose chunks' forward is then skipped."""
        es = self.engine_spec
        max_new = max_new_tokens or es.max_new_tokens
        assert max_new <= es.max_new_tokens
        dev = self.device
        b = len(prompt_ids)
        lens = [len(p) for p in prompt_ids]
        bucket = es.bucket_for(max(lens))
        if prefix is not None:
            self._check_prefix(prefix, prompt_ids, bucket)
        plan = self.plan_for(bucket)
        tokens = np.zeros((b, bucket), dtype=np.int64)
        for i, p in enumerate(prompt_ids):
            tokens[i, bucket - len(p):] = np.asarray(p, dtype=np.int64)
        tokens = torch.from_numpy(tokens).to(dev)
        true_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        rng = prng.PRNGKey(rng_seed, device=dev)

        t0 = time.perf_counter()
        if self.chunked_prefill_supported(bucket):
            logits, cache = self._run_chunked_prefill(
                bucket, tokens, true_len, prefix=prefix, lens=lens, rng=rng)
        else:
            logits, cache = llama.prefill(
                self.params, self.model_spec, plan, tokens, true_len,
                attention_impl=self.attention_impl,
                prefill_two_pass=es.prefill_two_pass, rng=rng)
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
        mm_bf16 = cache.quant is not None and llama.region_mm_bf16(
            es, self.model_spec, self.comp_spec,
            cache.quant.k.codes.shape[-2] * (8 // self.comp_spec.nbits))
        while steps < limit and not bool(done.all()):
            logits, cache = llama.decode_step(
                self.params, self.model_spec, plan, cache, token,
                attention_impl=self.attention_impl, f32_quant=self.f32_quant,
                mm_bf16=mm_bf16)
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

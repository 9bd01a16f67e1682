"""The port on trained weights: ``data/tiny_retrieval.npz`` (8 layers, GQA
8/4, D = 32, tied embeddings, trained on the needle task) loaded with numpy
alone on the port's side, one ~1000-token needle prompt built with the JAX
package's ``train.data`` helpers, and the port's greedy tokens (cap 64,
16 new tokens) held equal to a live JAX ``Engine.generate`` for seven
methods.  Here the selection decides what the model can retrieve, so a
wrong keep set shows as other tokens.  CPU, f32.
"""

import json
import os

import numpy as np
import pytest

from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(__file__), "..", "data",
                    "tiny_retrieval.npz")
METHODS = ["fullkv", "snapkv", "streamingllm", "l2norm", "random", "adakv",
           "think"]
COMP = dict(max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool")
ENG = dict(max_new_tokens=16, prefill_buckets=(1024,))


def _load_numpy(path):
    """The checkpoint as the port reads it: numpy only (no JAX)."""
    with np.load(path, allow_pickle=False) as z:
        spec = tcfg.ModelSpec(**json.loads(str(z["spec"])))
        tree = {}
        for name in z.files:
            if name.startswith("arr_"):
                *parents, leaf = name[4:].split("/")
                d = tree
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = np.asarray(z[name], np.float32)
    return spec, params_from_numpy(tree, device="cpu")


def _needle_prompt(tok):
    """One needle at mid depth in ~1000 tokens of filler, then the
    question, as the needle harness lays a prompt out."""
    from pyramidkv_tpu.train.data import (code, entity, filler_text,
                                          needle_question, needle_sentence)

    rng = np.random.default_rng(7)
    adj, noun = entity(rng)
    cw = code(rng)
    before, after = filler_text(rng, 470), filler_text(rng, 470)
    text = (before + needle_sentence(adj, noun, cw) + after
            + "\nQuestion: " + needle_question(adj, noun) + "\nAnswer:")
    ids = tok.encode(text)
    assert 900 <= len(ids) <= 1024, len(ids)
    return ids


@pytest.fixture(scope="module")
def rig():
    from pyramidkv_tpu.train import ToyTokenizer, load_checkpoint

    jparams, jspec = load_checkpoint(CKPT)
    tspec, tparams = _load_numpy(CKPT)
    return jparams, jspec, tspec, tparams, _needle_prompt(ToyTokenizer())


@pytest.mark.parametrize("method", METHODS)
def test_trained_greedy_tokens_match_jax(rig, method):
    from pyramidkv_tpu.config import CompressionSpec, EngineSpec
    from pyramidkv_tpu.engine import Engine as JaxEngine

    jparams, jspec, tspec, tparams, prompt = rig
    je = JaxEngine(jspec, CompressionSpec(method=method, **COMP),
                   EngineSpec(**ENG), jparams)
    te = Engine(tspec, tcfg.CompressionSpec(method=method, **COMP),
                tcfg.EngineSpec(**ENG), tparams, device="cpu")
    want = je.generate([prompt])
    got = te.generate([prompt])
    assert got.tokens == want.tokens
    assert got.kv_cache_bytes == want.kv_cache_bytes
    assert len(got.tokens[0]) == ENG["max_new_tokens"]

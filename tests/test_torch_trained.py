"""The port on trained weights: ``data/tiny_retrieval.npz`` (8 layers, GQA
8/4, D = 32, tied embeddings, trained on the needle task) loaded with numpy
alone on the port's side, one ~1000-token needle prompt built with the JAX
package's ``train.data`` helpers, and the port's greedy tokens (cap 64,
16 new tokens) held equal to a live JAX ``Engine.generate`` for seven
methods.  Here the selection decides what the model can retrieve, so a
wrong keep set shows as other tokens.  CPU, f32.

The needle grid's pin, ``tests/torch_trained_tokens.json``: JAX's greedy
tokens and ``kv_cache_bytes`` for each of the grid's 16 configurations
(fullkv; snapkv, pyramidkv, streamingllm, h2o, l2norm and random at caps
64 and 128; fullkv with KIVI 8/4/2 in the group layout), which
``chip_smoke.py`` holds the card's runs to (it cannot run JAX).  The pin
is held equal to a live JAX engine per configuration, and the port's CPU
tokens to the pin.  ``python tests/test_torch_trained.py --write``
rewrites it from live JAX.
"""

import json
import os
import re

import numpy as np
import pytest

from pyramidkv_tpu_torch import config as tcfg
from pyramidkv_tpu_torch.engine import Engine
from pyramidkv_tpu_torch.train import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(__file__), "..", "data",
                    "tiny_retrieval.npz")
PIN = os.path.join(os.path.dirname(__file__), "torch_trained_tokens.json")
METHODS = ["fullkv", "snapkv", "streamingllm", "l2norm", "random", "adakv",
           "think"]
COMP = dict(max_capacity_prompt=64, window_size=8, kernel_size=7,
            pooling="maxpool")
ENG = dict(max_new_tokens=16, prefill_buckets=(1024,))
#: the compressing methods of ACCURACY.md's needle grid, each at caps 64
#: and 128
GRID_METHODS = ["snapkv", "pyramidkv", "streamingllm", "h2o", "l2norm",
                "random"]
#: the grid configurations test_trained_greedy_tokens_match_jax covers; the
#: rest are held to the pin here
COVERED = {"fullkv", "snapkv cap64", "streamingllm cap64", "l2norm cap64",
           "random cap64"}


def _load_numpy(path):
    """The checkpoint as the port reads it: numpy only (no JAX), through
    the port's loader."""
    return load_checkpoint(path, device="cpu")


def grid_configs():
    """The needle grid's 16 configurations: name -> CompressionSpec
    arguments (shared by the JAX and port engines)."""
    out = {"fullkv": dict(method="fullkv", **COMP)}
    for cap in (64, 128):
        for m in GRID_METHODS:
            out[f"{m} cap{cap}"] = dict(COMP, method=m,
                                        max_capacity_prompt=cap)
    for nb in (8, 4, 2):
        out[f"fullkv kivi{nb}"] = dict(method="fullkv", quant_method="kivi",
                                       nbits=nb, q_layout="group", **COMP)
    return out


def _jax_run(jparams, jspec, prompt, comp):
    from pyramidkv_tpu.config import CompressionSpec, EngineSpec
    from pyramidkv_tpu.engine import Engine as JaxEngine

    r = JaxEngine(jspec, CompressionSpec(**comp), EngineSpec(**ENG),
                  jparams).generate([prompt])
    return {"tokens": [int(t) for t in r.tokens[0]],
            "kv_cache_bytes": int(r.kv_cache_bytes)}


def write_pin(path=PIN):
    """Regenerate the pin from live JAX engines (f32, CPU)."""
    from pyramidkv_tpu.train import ToyTokenizer, load_checkpoint as jload

    jparams, jspec = jload(CKPT)
    prompt = _needle_prompt(ToyTokenizer())
    entries = {name: {"comp": comp, **_jax_run(jparams, jspec, prompt, comp)}
               for name, comp in grid_configs().items()}
    text = json.dumps({"prompt": {"seed": 7, "filler": [470, 470],
                                  "bucket": ENG["prefill_buckets"][0],
                                  "max_new_tokens": ENG["max_new_tokens"],
                                  "ids": prompt},
                       "configs": entries}, indent=1)
    # lists of numbers on one line each
    text = re.sub(r"\[[\d,\s]*\]",
                  lambda m: "[" + ", ".join(m.group(0)[1:-1].split()).replace(
                      ",,", ",") + "]", text)
    with open(path, "w") as f:
        f.write(text + "\n")


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


@pytest.fixture(scope="module")
def pin():
    with open(PIN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def live_jax(rig):
    """Each grid configuration's tokens and kv_cache_bytes from a live JAX
    engine (one engine per configuration)."""
    jparams, jspec, _, _, prompt = rig
    return {name: _jax_run(jparams, jspec, prompt, comp)
            for name, comp in grid_configs().items()}


def test_pin_prompt_and_configs(rig, pin):
    assert pin["prompt"]["ids"] == rig[4]
    assert pin["prompt"]["bucket"] == ENG["prefill_buckets"][0]
    assert pin["prompt"]["max_new_tokens"] == ENG["max_new_tokens"]
    assert {n: e["comp"] for n, e in pin["configs"].items()} == grid_configs()


@pytest.mark.parametrize("name", list(grid_configs()))
def test_pin_matches_live_jax(pin, live_jax, name):
    got = pin["configs"][name]
    assert got["tokens"] == live_jax[name]["tokens"]
    assert got["kv_cache_bytes"] == live_jax[name]["kv_cache_bytes"]
    assert len(got["tokens"]) == ENG["max_new_tokens"]


@pytest.mark.parametrize(
    "name", [n for n in grid_configs() if n not in COVERED])
def test_port_matches_pin(rig, pin, name):
    """The port's CPU engine (f32) gives the pinned tokens and cache bytes
    for the grid configurations the seven-method test does not run."""
    _, _, tspec, tparams, prompt = rig
    te = Engine(tspec, tcfg.CompressionSpec(**grid_configs()[name]),
                tcfg.EngineSpec(**ENG), tparams, device="cpu")
    got = te.generate([prompt])
    want = pin["configs"][name]
    assert got.tokens[0] == want["tokens"]
    assert got.kv_cache_bytes == want["kv_cache_bytes"]


if __name__ == "__main__":
    import sys

    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_trained.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_pin()

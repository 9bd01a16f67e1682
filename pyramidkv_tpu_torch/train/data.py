"""The needle prompts of the trained tiny retrieval checkpoint: the port's
copy of the needle helpers of ``pyramidkv_tpu/train/data.py`` (filler
sentences, entities, codes, the needle sentence, question and answer), so
that the port lays out the checkpoint's prompts without the JAX package.
Each helper draws from a numpy ``Generator`` exactly as the JAX package's
does (the CPU tests hold the strings and their ids equal for several
seeds).  Training batches are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .tokenizer import (_CODE_WORDS, _ENTITY_ADJS, _ENTITY_NOUNS,
                        _FILLER_WORDS, ToyTokenizer)

_SUBJ = [w for w in _FILLER_WORDS if w in (
    "king queen knight wizard farmer merchant sailor doctor teacher "
    "child bird horse wolf bear fox dragon lion eagle".split())]
_VERB = [w for w in _FILLER_WORDS if w in (
    "walked found made took gave saw went came told asked heard kept "
    "held wrote read played watched called liked loved built carried "
    "brought showed helped".split())]
_OBJ = [w for w in _FILLER_WORDS if w in (
    "river mountain forest castle village city bridge tower garden "
    "harbor market temple library road field sky ocean island valley "
    "cave desert meadow stone tree flower".split())]
_ADV = [w for w in _FILLER_WORDS if w in (
    "slowly quickly carefully quietly suddenly finally often always "
    "never sometimes".split())]


def filler_sentence(rng: np.random.Generator) -> str:
    s = [
        "the", str(rng.choice(_SUBJ)), str(rng.choice(_VERB)),
        str(rng.choice(_ADV)), "to", "the", str(rng.choice(_OBJ)), ".",
    ]
    if rng.random() < 0.5:
        s = s[:3] + ["the", str(rng.choice(_OBJ)), "."]
    return " ".join(s)


def filler_text(rng: np.random.Generator, n_tokens: int,
                tok: Optional[ToyTokenizer] = None,
                pool: int = 0) -> str:
    """~``n_tokens`` tokens of filler (each sentence is 6-8 tokens);
    ``pool > 0``: sentences drawn with repetition from a per-document pool
    of that size."""
    src_pool = [filler_sentence(rng) for _ in range(pool)] if pool else None
    parts, count = [], 0
    while count < n_tokens:
        s = (src_pool[int(rng.integers(0, pool))] if src_pool
             else filler_sentence(rng))
        parts.append(s)
        count += s.count(" ") + 1
    return " ".join(parts)


def entity(rng: np.random.Generator) -> "tuple[str, str]":
    return str(rng.choice(_ENTITY_ADJS)), str(rng.choice(_ENTITY_NOUNS))


def code(rng: np.random.Generator, k: int = 5) -> "list[str]":
    return [str(w) for w in rng.choice(_CODE_WORDS, size=k, replace=True)]


def needle_sentence(adj: str, noun: str, code_words: "list[str]") -> str:
    # the {noun} repeats right before the code: the anchor the trained
    # model's induction head copies the code from
    return (f"\nthe secret code of the {adj} {noun} is {noun} "
            + " ".join(code_words) + " .\n")


def needle_question(adj: str, noun: str) -> str:
    return f"What is the secret code of the {adj} {noun} ?"


def needle_answer(adj: str, noun: str, code_words: "list[str]") -> str:
    # the full sentence restated, as the model was trained to answer
    return (f" the secret code of the {adj} {noun} is {noun} "
            + " ".join(code_words) + " .")


def needle_prompt(tok: ToyTokenizer, seed: int = 7, before: int = 470,
                  after: int = 470):
    """One needle between ``before`` and ``after`` tokens of filler, then the
    question: (prompt ids, the needle's code words).  The default is the
    CPU tests' prompt (seed 7: 900-1024 tokens)."""
    rng = np.random.default_rng(seed)
    adj, noun = entity(rng)
    cw = code(rng)
    context = (filler_text(rng, before) + needle_sentence(adj, noun, cw)
               + filler_text(rng, after))
    question = needle_question(adj, noun)
    return tok.encode(context + "\nQuestion: " + question + "\nAnswer:"), cw

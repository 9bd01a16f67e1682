"""Closed-vocabulary word-level tokenizer of the trained tiny retrieval
checkpoint (``data/tiny_retrieval.npz``): the port's own copy of
``pyramidkv_tpu/train/tokenizer.py`` (regex and dataclasses only), so that
the port builds the checkpoint's prompts without the JAX package.

The toy language is a CLOSED word list tokenized by whitespace with
punctuation split off; the vocab is the tokenizer, so the checkpoint's
training and this copy must agree word for word (the CPU tests hold
``encode`` / ``decode`` equal to the JAX package's).  The class exposes
the HF-tokenizer surface the needle prompts use: ``encode(text,
add_special_tokens=)``, ``decode(ids, skip_special_tokens=)``,
``tokenizer(text).input_ids`` and ``eos_token_id``.

Decode inverts encode on in-vocabulary text.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# Word classes of the toy language (deterministic — the tokenizer IS the
# vocab file; training and eval must agree byte-for-byte).
_FILLER_WORDS = """
the a an and or but of in on at to from with for by over under near far
big small old new good bad red blue green white black bright dark tall
short warm cold quiet loud happy sad king queen knight wizard farmer
merchant sailor doctor teacher child river mountain forest castle
village city bridge tower garden harbor market temple library road
field sky ocean island valley cave desert meadow storm wind rain snow
sun moon star cloud fire stone tree flower bird horse wolf bear fox
fish dragon lion eagle snake walked looked found made took gave saw
went came said told asked thought knew felt heard left kept held wrote
read sang played worked lived stayed moved turned opened closed built
broke carried brought sent showed helped watched waited called liked
loved needed wanted tried used started finished morning evening night
day week month year spring summer autumn winter today tomorrow often
always never sometimes slowly quickly carefully quietly suddenly
finally almost very quite rather really still just even also then there
here where when while because although before after during against
between among through around behind beside beyond inside outside
""".split()

_CODE_WORDS = """
alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo
lima mike november oscar papa quebec romeo sierra tango uniform victor
whiskey xray yankee zulu zero one two three four five six seven eight
nine
""".split()

_ENTITY_ADJS = """
crimson silver golden emerald amber ivory obsidian scarlet azure jade
violet copper marble crystal iron bronze pearl ruby sapphire topaz
""".split()

_ENTITY_NOUNS = """
falcon lantern compass anchor chalice scepter crown mirror gate vault
banner shield helm drum bell flute harp loom quill scroll
""".split()

_TEMPLATE_WORDS = """
This is very long story book Based content Question Answer secret code
What value key best thing do magic number repeat list item
""".split()

_SPECIALS = ["<pad>", "<bos>", "<eos>", "<unk>", "<nl>",
             "<|im_start|>", "<book>", "</book>"]
_PUNCT = [".", ",", ":", "?", "!", ";"]

_SPLIT_RE = re.compile(r"(<\|im_start\|>|</book>|<book>|[.,:?!;])")


def default_vocab() -> "list[str]":
    seen, out = set(), []
    for w in (_SPECIALS + _PUNCT + _FILLER_WORDS + _CODE_WORDS
              + _ENTITY_ADJS + _ENTITY_NOUNS + _TEMPLATE_WORDS):
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


@dataclass
class ToyTokenizer:
    """HF-surface word tokenizer over the closed vocab."""

    vocab: "list[str]" = field(default_factory=default_vocab)

    def __post_init__(self):
        self._id = {w: i for i, w in enumerate(self.vocab)}
        self.pad_token_id = self._id["<pad>"]
        self.bos_token_id = self._id["<bos>"]
        self.eos_token_id = self._id["<eos>"]
        self.unk_token_id = self._id["<unk>"]
        self._special_strip = {self.pad_token_id, self.bos_token_id,
                               self.eos_token_id}

    # -- vocab surface ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- encode -----------------------------------------------------------
    def _words(self, text: str) -> "list[str]":
        text = text.replace("\n", " <nl> ")
        parts = []
        for chunk in text.split():
            for piece in _SPLIT_RE.split(chunk):
                if piece:
                    parts.append(piece)
        return parts

    def encode(self, text: str, add_special_tokens: bool = False
               ) -> "list[int]":
        ids = [self._id.get(w, self.unk_token_id) for w in self._words(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True,
                 truncation: bool = False, max_length: int = None):
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        if truncation and max_length is not None:
            ids = ids[:max_length]

        class _Enc:
            input_ids = ids

        return _Enc()

    # -- decode -----------------------------------------------------------
    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = []
        for t in ids:
            t = int(t)
            if skip_special_tokens and t in self._special_strip:
                continue
            w = self.vocab[t] if 0 <= t < len(self.vocab) else "<unk>"
            if w == "<nl>":
                out.append("\n")
            else:
                out.append(w)
        # join with spaces, then tighten punctuation (encode splits it
        # back off, so the roundtrip is stable)
        text = " ".join(out)
        text = text.replace(" \n ", "\n").replace(" \n", "\n").replace(
            "\n ", "\n")
        return text

    def convert_ids_to_tokens(self, ids) -> "list[str]":
        return [self.vocab[int(t)] for t in ids]

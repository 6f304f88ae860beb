"""CLIP BPE tokenizer (self-contained, HF vocab layout) + a test stub.

Replaces transformers' AutoTokenizer as loaded by the reference
(test_fatezero.py:82-87) without any hub access: reads ``vocab.json`` +
``merges.txt`` from a checkpoint's ``tokenizer/`` subfolder (the HF
from_pretrained layout, SURVEY.md §5 checkpoint/resume). The prompt-to-prompt
word-index logic (ptp/ptp_utils.get_word_inds) needs `encode` and
single-token `decode`, both provided.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte->unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word markers and special tokens."""

    def __init__(self, vocab: Dict[str, int], merges: List[str], max_length: int = 77):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        ranks = {}
        for i, merge in enumerate(merges):
            pair = tuple(merge.split())
            if len(pair) == 2:
                ranks[pair] = i
        self.bpe_ranks = ranks
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = max_length
        self.bos_token_id = vocab.get("<|startoftext|>", 49406)
        self.eos_token_id = vocab.get("<|endoftext|>", 49407)
        # CLIP's pattern uses \p{L}/\p{N}; stdlib `re` equivalents:
        # [^\W\d_]+ = unicode letters, \d = unicode digit, (?:[^\s\w]|_)+ =
        # neither whitespace nor letter/digit. Keeps 'café' one letter-run,
        # matching the HF/OpenAI tokenizer on non-ASCII prompts.
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
            re.IGNORECASE,
        )
        self._bpe_cache: Dict[str, str] = {}

    # -- loading -----------------------------------------------------------
    @classmethod
    def from_pretrained(cls, path: str, subfolder: str = "tokenizer", **kw) -> "CLIPTokenizer":
        base = os.path.join(path, subfolder) if subfolder else path
        vocab_file = os.path.join(base, "vocab.json")
        merges_file = os.path.join(base, "merges.txt")
        with open(vocab_file) as f:
            vocab = json.load(f)
        if os.path.exists(merges_file):
            with open(merges_file) as f:
                merges = f.read().split("\n")
        else:  # OpenAI .txt.gz format
            with gzip.open(merges_file + ".gz", "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        # HF merges.txt carries a version header line
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        return cls(vocab, [m for m in merges if m], **kw)

    @classmethod
    def from_openai_bpe(cls, bpe_path: str, **kw) -> "CLIPTokenizer":
        """Build from OpenAI's bpe_simple_vocab_16e6.txt.gz (no vocab.json):
        the vocab is derived from the merge list exactly as OpenAI's
        SimpleTokenizer derives it, yielding the standard 49408-entry CLIP
        vocabulary."""
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [m for m in lines[1 : 49152 - 256 - 2 + 1] if m]
        chars = list(bytes_to_unicode().values())
        vocab_list = chars + [c + "</w>" for c in chars]
        vocab_list += ["".join(m.split()) for m in merges]
        vocab_list += ["<|startoftext|>", "<|endoftext|>"]
        vocab = {tok: i for i, tok in enumerate(vocab_list)}
        return cls(vocab, merges, **kw)

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        """Token ids without special tokens."""
        text = whitespace_clean(basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def encode(self, text: str) -> List[int]:
        """bos + tokens + eos (matches transformers CLIPTokenizer.encode)."""
        return [self.bos_token_id] + self.tokenize_ids(text) + [self.eos_token_id]

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        text = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace")
        return text.replace("</w>", " ").strip()

    def __call__(
        self,
        text,
        max_length: int | None = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: str | None = None,
    ):
        import numpy as np

        max_length = max_length or self.model_max_length
        if isinstance(text, str):
            text = [text]
        rows = []
        for t in text:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            if padding == "max_length":
                # transformers CLIPTokenizer pads with eos
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            rows.append(ids)

        class _Out:
            input_ids = np.asarray(rows, dtype=np.int64)

        return _Out()


class StubTokenizer(CLIPTokenizer):
    """Deterministic word-level tokenizer for tests (no vocab files on disk):
    every whitespace word maps to a stable id; decode inverts it."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.bos_token_id = 0
        self.eos_token_id = 1
        self._ids: Dict[str, int] = {}
        self._words: Dict[int, str] = {}

    def tokenize_ids(self, text: str):
        out = []
        for w in whitespace_clean(basic_clean(text)).lower().split(" "):
            if not w:
                continue
            if w not in self._ids:
                i = 2 + (hash(w) % (self.vocab_size - 2))
                while i in self._words and self._words[i] != w:
                    i = 2 + ((i - 1) % (self.vocab_size - 2))
                self._ids[w] = i
                self._words[i] = w
            out.append(self._ids[w])
        return out

    def decode(self, ids):
        return " ".join(self._words.get(int(i), "") for i in ids).strip()

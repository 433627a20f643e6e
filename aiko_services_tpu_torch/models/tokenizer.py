# Byte-level BPE tokenizer: the real-text path into the LM/ASR elements.
#
# Counterpart of aiko_services_tpu/models/tokenizer.py, copied unchanged
# (pure Python; the port imports nothing of the JAX package), with its own
# copy of the committed asset, assets/bpe_default.json.
#
# The reference delegates tokenization to external runtimes (reference:
# src/aiko_services/examples/llm/elements_llm.py:137-179 shells out to
# Ollama; speech_elements.py:229-262 to whisperx) so it ships none.  A
# standalone framework needs its own: this is GPT-2-family byte-level BPE --
# every UTF-8 byte maps to a printable unicode "symbol", merges are learned
# over symbol pairs, so ANY string round-trips losslessly with no <unk>.
#
# Three ways to get a tokenizer:
#   - BPETokenizer.from_file("tokenizer.json")  loads the HuggingFace
#     tokenizer.json format (vocab + merges), so real Llama/GPT vocabularies
#     drop in;
#   - train_bpe(texts, vocab_size)  trains from scratch (used to build the
#     committed default asset, zero-egress);
#   - BPETokenizer.default()  loads the committed asset.

from __future__ import annotations

import json
import re
from pathlib import Path

__all__ = ["BPETokenizer", "train_bpe"]

# GPT-2-style pre-tokenization: contractions, words-with-leading-space,
# number runs, punctuation runs, whitespace
_PRETOKEN_PATTERN = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    r"| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
    re.UNICODE)

_DEFAULT_SPECIALS = ("<pad>", "<s>", "</s>")
_DEFAULT_ASSET = Path(__file__).parent / "assets" / "bpe_default.json"


def _bytes_to_unicode() -> dict[int, str]:
    """Map every byte 0..255 to a printable unicode char (printable ASCII
    and latin-1 map to themselves; the rest shift into U+0100+)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    mapping = {}
    offset = 0
    for byte in range(256):
        if byte in keep:
            mapping[byte] = chr(byte)
        else:
            mapping[byte] = chr(0x100 + offset)
            offset += 1
    return mapping


_BYTE_TO_CHAR = _bytes_to_unicode()
_CHAR_TO_BYTE = {char: byte for byte, char in _BYTE_TO_CHAR.items()}


def _text_to_symbols(text: str) -> list[str]:
    return [_BYTE_TO_CHAR[b] for b in text.encode("utf-8")]


class BPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: dict[str, int] | None = None):
        self.vocab = dict(vocab)
        self.merges = [tuple(m) for m in merges]
        self.special_tokens = dict(special_tokens or {})
        self._ranks = {pair: rank for rank, pair in enumerate(self.merges)}
        self._id_to_token = {token_id: token
                             for token, token_id in self.vocab.items()}
        for token, token_id in self.special_tokens.items():
            self._id_to_token.setdefault(token_id, token)
        self._cache: dict[str, list[int]] = {}

    # -- token id properties ------------------------------------------------

    @property
    def vocab_size(self) -> int:
        ids = list(self.vocab.values()) + list(self.special_tokens.values())
        return max(ids) + 1 if ids else 0

    @property
    def pad_id(self) -> int | None:
        return self.special_tokens.get("<pad>")

    @property
    def bos_id(self) -> int | None:
        return self.special_tokens.get("<s>")

    @property
    def eos_id(self) -> int | None:
        return self.special_tokens.get("</s>")

    # -- encode / decode ----------------------------------------------------

    def _bpe(self, symbols: list[str]) -> list[str]:
        """Greedily apply the lowest-rank merge until none applies."""
        while len(symbols) > 1:
            best_rank, best_index = None, None
            for index in range(len(symbols) - 1):
                rank = self._ranks.get((symbols[index], symbols[index + 1]))
                if rank is not None and (best_rank is None
                                         or rank < best_rank):
                    best_rank, best_index = rank, index
            if best_index is None:
                break
            symbols = (symbols[:best_index]
                       + [symbols[best_index] + symbols[best_index + 1]]
                       + symbols[best_index + 2:])
        return symbols

    def _encode_pretoken(self, pretoken: str) -> list[int]:
        cached = self._cache.get(pretoken)
        if cached is not None:
            return cached
        pieces = self._bpe(_text_to_symbols(pretoken))
        ids = []
        for piece in pieces:
            token_id = self.vocab.get(piece)
            if token_id is not None:
                ids.append(token_id)
            else:  # unmerged symbols always exist as single-char tokens
                ids.extend(self.vocab[char] for char in piece)
        if len(self._cache) < 65536:
            self._cache[pretoken] = ids
        return ids

    def encode(self, text: str, bos: bool = False,
               eos: bool = False) -> list[int]:
        ids: list[int] = []
        if bos and self.bos_id is not None:
            ids.append(self.bos_id)
        for pretoken in _PRETOKEN_PATTERN.findall(text):
            ids.extend(self._encode_pretoken(pretoken))
        if eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids) -> str:
        special_ids = set(self.special_tokens.values())
        chars = []
        for token_id in ids:
            token_id = int(token_id)
            if token_id in special_ids:
                continue
            token = self._id_to_token.get(token_id)
            if token is not None:
                chars.append(token)
        data = bytes(_CHAR_TO_BYTE[char]
                     for token in chars for char in token
                     if char in _CHAR_TO_BYTE)
        return data.decode("utf-8", errors="replace")

    # -- persistence --------------------------------------------------------

    def save(self, path) -> None:
        Path(path).write_text(json.dumps({
            "type": "bpe",
            "vocab": self.vocab,
            "merges": [list(m) for m in self.merges],
            "special_tokens": self.special_tokens,
        }, ensure_ascii=False))

    @classmethod
    def from_file(cls, path) -> "BPETokenizer":
        data = json.loads(Path(path).read_text())
        if "model" in data:  # HuggingFace tokenizer.json
            model = data["model"]
            vocab = model["vocab"]
            merges = []
            for merge in model.get("merges", []):
                if isinstance(merge, str):
                    left, right = merge.split(" ", 1)
                else:
                    left, right = merge
                merges.append((left, right))
            specials = {}
            for added in data.get("added_tokens", []):
                content = added.get("content", "")
                if "begin" in content or content in ("<s>",
                                                     "<|begin_of_text|>"):
                    specials["<s>"] = added["id"]
                elif "end" in content or content in ("</s>",
                                                     "<|end_of_text|>"):
                    specials["</s>"] = added["id"]
                elif "pad" in content:
                    specials["<pad>"] = added["id"]
            return cls(vocab, merges, specials)
        return cls(data["vocab"],
                   [tuple(m) for m in data["merges"]],
                   data.get("special_tokens"))

    @classmethod
    def default(cls) -> "BPETokenizer":
        """The committed zero-egress asset (trained by train_bpe on the
        repository's own documentation corpus)."""
        return cls.from_file(_DEFAULT_ASSET)


def train_bpe(texts, vocab_size: int,
              special_tokens=_DEFAULT_SPECIALS) -> BPETokenizer:
    """Classic BPE training over byte-level symbols.

    Specials take ids 0..S-1, the 256 byte symbols follow, then merges
    until vocab_size.  Incremental pair-count maintenance keeps training
    fast enough for multi-thousand-token vocabularies in pure Python.
    """
    word_counts: dict[tuple, int] = {}
    for text in texts:
        for pretoken in _PRETOKEN_PATTERN.findall(text):
            word = tuple(_text_to_symbols(pretoken))
            if word:
                word_counts[word] = word_counts.get(word, 0) + 1

    pair_counts: dict[tuple, int] = {}
    pair_words: dict[tuple, set] = {}

    def count_word(word, count, sign):
        for pair in zip(word, word[1:]):
            pair_counts[pair] = pair_counts.get(pair, 0) + sign * count
            if sign > 0:
                pair_words.setdefault(pair, set()).add(word)
            elif pair_counts.get(pair, 0) <= 0:
                pair_counts.pop(pair, None)
                pair_words.pop(pair, None)

    for word, count in word_counts.items():
        count_word(word, count, +1)

    n_specials = len(special_tokens)
    base_symbols = sorted(set(_BYTE_TO_CHAR.values()))
    vocab = {symbol: n_specials + index
             for index, symbol in enumerate(base_symbols)}
    merges: list[tuple[str, str]] = []

    while len(vocab) + n_specials < vocab_size and pair_counts:
        best_pair = max(pair_counts, key=lambda p: (pair_counts[p], p))
        if pair_counts[best_pair] < 2:
            break
        merges.append(best_pair)
        merged_symbol = best_pair[0] + best_pair[1]
        vocab[merged_symbol] = n_specials + len(vocab)
        affected = list(pair_words.get(best_pair, ()))
        for word in affected:
            count = word_counts.pop(word, 0)
            if count == 0:
                continue
            count_word(word, count, -1)
            new_word = []
            index = 0
            while index < len(word):
                if (index < len(word) - 1
                        and (word[index], word[index + 1]) == best_pair):
                    new_word.append(merged_symbol)
                    index += 2
                else:
                    new_word.append(word[index])
                    index += 1
            new_word = tuple(new_word)
            word_counts[new_word] = word_counts.get(new_word, 0) + count
            count_word(new_word, count, +1)

    specials = {token: index for index, token in enumerate(special_tokens)}
    return BPETokenizer(vocab, merges, specials)

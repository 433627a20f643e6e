# The port's BPE tokenizer (a copy of the JAX package's pure-Python
# tokenizer, with its own copy of the committed asset) against the JAX
# package's: the same ids for the same strings, the same text back.

import json

import pytest

from aiko_services_tpu.models import tokenizer as jax_tokenizer
from aiko_services_tpu_torch.models import tokenizer as torch_tokenizer

TEXTS = [
    "",
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog.",
    "  leading and   repeated   spaces\tand\ttabs\n",
    "numbers 1234567890 and 3.14159, dates 2026-10-16",
    "contractions: it's, we're, they've, I'm, you'll, he'd",
    "naïve café — déjà vu, Ünïcödé",
    "日本語のテキストと中文",
    "emoji 🙂🚀 and symbols ©®™ ∑∫√",
    "(pipeline (asr (text) (lm (reply))) (detector))",
    "snake_case_names and CamelCase and __dunder__",
]


@pytest.fixture(scope="module")
def tokenizers():
    return (jax_tokenizer.BPETokenizer.default(),
            torch_tokenizer.BPETokenizer.default())


@pytest.mark.parametrize("index", range(len(TEXTS)))
def test_encode_decode_identical_to_jax(tokenizers, index):
    reference, port = tokenizers
    text = TEXTS[index]
    for bos, eos in ((False, False), (True, True)):
        ids = port.encode(text, bos=bos, eos=eos)
        assert ids == reference.encode(text, bos=bos, eos=eos)
        assert port.decode(ids) == reference.decode(ids) == text


def test_default_asset_is_a_copy_of_the_jax_packages():
    reference = json.loads(jax_tokenizer._DEFAULT_ASSET.read_text())
    copy = json.loads(torch_tokenizer._DEFAULT_ASSET.read_text())
    assert copy == reference
    assert torch_tokenizer._DEFAULT_ASSET.parent.parent.name == "models"
    assert "aiko_services_tpu_torch" in str(torch_tokenizer._DEFAULT_ASSET)
    port = torch_tokenizer.BPETokenizer.default()
    assert (port.vocab_size, port.pad_id, port.bos_id, port.eos_id) == (
        4096, 0, 1, 2)


def test_trained_tokenizer_round_trips_like_jax(tmp_path):
    corpus = TEXTS * 3
    reference = jax_tokenizer.train_bpe(corpus, vocab_size=300)
    port = torch_tokenizer.train_bpe(corpus, vocab_size=300)
    assert port.merges == reference.merges and port.vocab == reference.vocab
    path = tmp_path / "bpe.json"
    port.save(path)
    loaded = jax_tokenizer.BPETokenizer.from_file(path)
    for text in TEXTS:
        assert loaded.encode(text) == port.encode(text)
        assert port.decode(port.encode(text)) == text

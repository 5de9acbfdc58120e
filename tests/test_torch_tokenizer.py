"""Port tokenizers against the JAX package's ``data/tokenizer.py``: the
char and BPE tokenizers trained on the same texts give the same
vocabulary, merges and ids, ``save`` writes identical bytes, and each
package loads the other's files. The special ids are defined once in the
port and shared with its beam search."""

import pytest

pytest.importorskip("torch")

from speech_tranformer_pytorch_tpu.data import tokenizer as jtok  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.data import tokenizer as ptok  # noqa: E402
from speech_tranformer_pytorch_tpu_torch.decoding import beam  # noqa: E402

CHAR_TEXTS = ["你好 世界", "好 的", "绿 是 阳春", "abc Def", "的的 的"]
WORD_TEXTS = ["the cat sat on the mat", "the dog sat", "a cat and a dog",
              "cats and dogs sat on mats", "on the mat the cat sat"]


def _pair(kind):
    if kind == "char":
        return (jtok.CharTokenizer.train(CHAR_TEXTS, min_count=1),
                ptok.CharTokenizer.train(CHAR_TEXTS, min_count=1), CHAR_TEXTS)
    return (jtok.BpeTokenizer.train(WORD_TEXTS, 40),
            ptok.BpeTokenizer.train(WORD_TEXTS, 40), WORD_TEXTS)


def test_specials_defined_once():
    assert (ptok.PAD, ptok.SOS, ptok.EOS, ptok.UNK) == (jtok.PAD, jtok.SOS, jtok.EOS,
                                                        jtok.UNK)
    assert (beam.PAD, beam.SOS, beam.EOS) == (ptok.PAD, ptok.SOS, ptok.EOS)
    assert ptok.SPECIALS == jtok.SPECIALS


@pytest.mark.parametrize("kind", ["char", "bpe"])
def test_train_encode_decode_match(kind):
    j, p, texts = _pair(kind)
    assert p.vocab == j.vocab
    assert getattr(p, "merges", None) == getattr(j, "merges", None)
    for t in texts + ["unseen 字 words zz"]:
        ids = p.encode(t)
        assert ids == j.encode(t)
        assert p.decode(ids) == j.decode(ids)
        assert p.decode(ids + [ptok.EOS, ptok.PAD]) == j.decode(ids)
    assert ptok.normalize_text(" a b\tc 你 ") == jtok.normalize_text(" a b\tc 你 ")


@pytest.mark.parametrize("kind", ["char", "bpe"])
def test_save_bytes_and_cross_load(kind, tmp_path):
    j, p, texts = _pair(kind)
    jp, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    j.save(jp)
    p.save(pp)
    assert open(pp, "rb").read() == open(jp, "rb").read()
    for loaded, other in ((ptok.load_tokenizer(jp), j), (jtok.load_tokenizer(pp), p)):
        assert type(loaded).__name__ == type(other).__name__
        assert loaded.vocab == other.vocab
        assert [loaded.encode(t) for t in texts] == [other.encode(t) for t in texts]
    cls = ptok.CharTokenizer if kind == "char" else ptok.BpeTokenizer
    assert cls.load(jp).vocab == j.vocab
    with pytest.raises(ValueError):
        (ptok.BpeTokenizer if kind == "char" else ptok.CharTokenizer).load(jp)

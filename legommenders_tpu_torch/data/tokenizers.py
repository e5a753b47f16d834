"""Tokenizer specs for `process --tokenizers`.

The port's own copy of the JAX package's data/tokenizers.py (host-side
numpy; nothing here touches a device).

Resolves a spec string into a `(vocab_name, tokenize_fn, vocab)` triple that
processors consume as `extra_tokenizers` entries (per-attribute `@name`
columns, mirroring the reference's per-tokenizer attribute variants,
processor/mind_processor.py:62-88).

Spec forms:
  ``glove:/path/to/glove.6B.300d.txt``  word vocab from a local GloVe file
                                        (no-egress: file must be local);
                                        OOV words are dropped.
  ``word``                              growable whitespace/punct word vocab
                                        (same tokenizer the processors use
                                        for their base columns).
  ``<name>`` (e.g. ``bertbase``)        HF AutoTokenizer loaded from the
                                        local checkpoint path registered in
                                        the ``.model`` dotfile.

All tokenize functions map ``str -> List[int]``; truncation to the CLI's
``--lm_truncate`` happens in the processor.
"""
import re
from typing import Callable, List, Tuple

from legommenders_tpu_torch.data.vocab import Vocab

_WORD = re.compile(r"[A-Za-z0-9']+")


def _word_fn(vocab: Vocab, grow: bool) -> Callable[[str], List[int]]:
    def fn(text: str) -> List[int]:
        words = _WORD.findall((text or "").lower())
        if grow:
            return [vocab.add(w) for w in words]
        ids = (vocab.get(w) for w in words)
        return [i for i in ids if i is not None]
    return fn


def resolve(spec: str) -> Tuple[str, Callable[[str], List[int]], Vocab]:
    """Resolve one --tokenizers spec to (name, fn, vocab).

    Raises SystemExit with an actionable message when the spec names an HF
    model with no `.model` dotfile entry (the only way to get weights in a
    no-egress image) or when transformers cannot load it.
    """
    spec = spec.strip()
    if spec.lower().startswith("glove:"):
        path = spec.split(":", 1)[1]
        from legommenders_tpu_torch.embedders.glove import parse_glove_text
        try:
            words, _ = parse_glove_text(path)
        except OSError as e:
            raise SystemExit(f"cannot read GloVe file {path}: {e}")
        vocab = Vocab("glove", tokens=words)
        return "glove", _word_fn(vocab, grow=False), vocab

    if spec.lower() == "word":
        vocab = Vocab("word", tokens=[])
        return "word", _word_fn(vocab, grow=True), vocab

    # HF tokenizer resolved through the .model dotfile (reference
    # utils/config_init.py ModelInit; no-egress: path must be local)
    from legommenders_tpu_torch.config.dotfiles import ModelInit
    path = ModelInit.get(spec)
    if path is None:
        raise SystemExit(
            f"tokenizer '{spec}' has no .model dotfile entry; add a line "
            f"`{spec}: /local/checkpoint/path` (no network egress)")
    try:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(path)
    except Exception as e:  # noqa: BLE001 — surfaced as a CLI error
        raise SystemExit(f"cannot load HF tokenizer '{spec}' from {path}: {e}")
    vocab = Vocab(spec, tokens=None).set_size(int(tok.vocab_size))

    def fn(text: str) -> List[int]:
        return list(tok(text or "", add_special_tokens=False)["input_ids"])

    return spec, fn, vocab

"""Class-description / text-embedding pipeline (pure Python + numpy).

Parity targets in the reference:

* ``clean_desc`` (misc.py:220-226): lowercase + word-tokenize, de-duplicate,
  strip stopwords and punctuation.
* ``read_data`` (misc.py:229-254): parse ``label_id,label,description`` CSV
  into per-class token lists plus label-id <-> index mappings.
* ``embed`` (misc.py:305-320): single-pass GloVe text-file scan attaching a
  vector to every in-vocabulary word.
* ``cbow`` (misc.py:323-340): per-class mean word vector plus the per-word
  vector set (zeros for out-of-vocabulary words).

Design deviations (documented):

* De-duplication uses an order-preserving ``dict.fromkeys`` rather than the
  reference's ``list(set(words))``. Python string hashing is salted per
  process, so the reference's token order — and therefore the fp-summation
  order inside ``cbow`` — is not reproducible even against itself across
  runs. Order-preserving dedup gives a deterministic, run-stable order.
* Tokenization uses NLTK's data-free ``TreebankWordTokenizer`` (the same
  algorithm behind ``word_tokenize``) so no network corpus download is
  required; if a full NLTK ``punkt`` install exists, ``word_tokenize`` is
  used instead.
"""

from __future__ import annotations

import string
from typing import Callable, Dict, List, Optional

import numpy as np

from multimodalgame_tpu_torch.data.stopwords import english_stopwords

_TOKENIZE: Optional[Callable[[str], List[str]]] = None


def _tokenizer() -> Callable[[str], List[str]]:
    global _TOKENIZE
    if _TOKENIZE is not None:
        return _TOKENIZE
    try:
        from nltk.tokenize import word_tokenize
        word_tokenize("probe")  # raises LookupError without punkt data
        _TOKENIZE = word_tokenize
    except Exception:
        from nltk.tokenize.treebank import TreebankWordTokenizer
        _TOKENIZE = TreebankWordTokenizer().tokenize
    return _TOKENIZE


def clean_desc(desc: str) -> List[str]:
    """Lowercase, tokenize, de-duplicate, and strip stopwords/punctuation
    (reference misc.py:220-226)."""
    words = _tokenizer()(desc.lower())
    words = list(dict.fromkeys(words))  # order-preserving de-duplication
    stop = set(english_stopwords())
    words = [w for w in words if w not in stop]
    words = [w for w in words if w not in string.punctuation]
    return words


def read_data(input_descr: str):
    """Parse a description CSV into token lists and label mappings
    (reference misc.py:229-254).

    Returns ``(descr, word_dict, dict_size, label_id_to_idx, idx_to_label)``
    where ``descr[i] = {"name": label, "desc": [tokens]}`` indexed by CSV
    line number, and ``label_id_to_idx`` maps the file's arbitrary label ids
    onto ``range(num_classes)``.
    """
    descr: Dict[int, dict] = {}
    word_dict: Dict[str, dict] = {}
    dict_size = 0
    num_descr = 0
    label_id_to_idx: Dict[int, int] = {}
    idx_to_label: Dict[int, str] = {}
    with open(input_descr, "r") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue  # tolerate blank lines (e.g. a trailing newline)
            parts = line.split(",")
            if len(parts) < 3:
                raise ValueError(
                    f"{input_descr}:{lineno}: expected "
                    f"'label_id,label,description', got {line!r}")
            label_id, label = parts[:2]
            try:
                label_id_int = int(label_id)
            except ValueError:
                raise ValueError(
                    f"{input_descr}:{lineno}: label_id {label_id!r} is "
                    "not an integer (is this a header row?)") from None
            desc = line[len(label_id) + len(label) + 2:]
            tokens = clean_desc(desc)
            for w in tokens:
                if w not in word_dict:
                    dict_size += 1
                    word_dict[w] = {"id": dict_size}
            descr[num_descr] = {"name": label, "desc": tokens}
            label_id_to_idx[label_id_int] = num_descr
            idx_to_label[num_descr] = label
            num_descr += 1
    return descr, word_dict, dict_size, label_id_to_idx, idx_to_label


def embed(word_dict: Dict[str, dict], emb_path: str) -> Dict[str, dict]:
    """Attach GloVe vectors to in-vocabulary words via one pass over the
    embedding text file (reference misc.py:305-320). Missing words get
    ``None``."""
    glove: Dict[str, np.ndarray] = {}
    with open(emb_path, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            if parts[0] in word_dict:
                glove[parts[0]] = np.asarray(
                    [float(s) for s in parts[1:]], dtype=np.float32)
    for k in word_dict:
        word_dict[k]["emb"] = glove.get(k, None)
    return word_dict


def fake_embed(word_dict: Dict[str, dict], wv_dim: int,
               seed: int = 0) -> Dict[str, dict]:
    """Deterministic random embeddings — the test/fixture analog of the
    reference's ``wv_type="fake"`` path (model.py:1067-1069)."""
    rng = np.random.RandomState(seed)
    for k in sorted(word_dict):
        word_dict[k]["emb"] = rng.randn(wv_dim).astype(np.float32)
    return word_dict


def cbow(descr: Dict[int, dict], word_dict: Dict[str, dict]):
    """Per-class CBOW mean vector and per-word vector set
    (reference misc.py:323-340)."""
    emb_size = None
    for v in word_dict.values():
        if v.get("emb") is not None:
            emb_size = len(v["emb"])
            break
    if emb_size is None:
        raise ValueError("no word in the vocabulary has an embedding")
    for cls in descr:
        num_w = 0
        desc_len = len(descr[cls]["desc"])
        desc_set = np.zeros((desc_len, emb_size), dtype=np.float32)
        for i_w, w in enumerate(descr[cls]["desc"]):
            if word_dict[w]["emb"] is not None:
                desc_set[i_w] = word_dict[w]["emb"]
                num_w += 1
        desc_cbow = desc_set.sum(0)
        if num_w > 0:
            desc_cbow = desc_cbow / num_w
        descr[cls]["cbow"] = desc_cbow
        descr[cls]["set"] = desc_set
    return descr


class DescriptionPack:
    """Description bundle consumed by the exchange.

    Mirrors the dict the reference assembles in run() (model.py:1078-1104):
    ``desc`` is the (num_classes, wv_dim) CBOW matrix, ``desc_set`` the
    concatenated per-word vectors, and ``desc_set_lens`` the per-class word
    counts. Adds a dense padded view (``desc_set_padded`` + ``desc_set_mask``)
    for word-level description attention, as the JAX package does.
    """

    def __init__(self, desc: np.ndarray, desc_set: np.ndarray,
                 desc_set_lens: List[int],
                 label_id_to_idx: Optional[Dict[int, int]] = None,
                 idx_to_label: Optional[Dict[int, str]] = None):
        self.desc = np.asarray(desc, dtype=np.float32)
        self.desc_set = np.asarray(desc_set, dtype=np.float32)
        self.desc_set_lens = list(desc_set_lens)
        self.label_id_to_idx = label_id_to_idx or {}
        self.idx_to_label = idx_to_label or {}

        num_classes = self.desc.shape[0]
        wv_dim = self.desc.shape[1]
        max_len = max(self.desc_set_lens) if self.desc_set_lens else 0
        padded = np.zeros((num_classes, max_len, wv_dim), dtype=np.float32)
        mask = np.zeros((num_classes, max_len), dtype=np.float32)
        off = 0
        for i, n in enumerate(self.desc_set_lens):
            padded[i, :n] = self.desc_set[off:off + n]
            mask[i, :n] = 1.0
            off += n
        self.desc_set_padded = padded
        self.desc_set_mask = mask

    @property
    def num_classes(self) -> int:
        return self.desc.shape[0]

    def map_labels(self, x: int) -> int:
        """Dataset label id -> dense class index.

        The reference's ``dict.get`` returns ``None`` for an id absent
        from the description CSV and then crashes opaquely inside tensor
        construction (model.py:1075/1090, misc.py:290) — fail here with
        the offending id instead, since a miss always means a mismatched
        dataset/CSV pair."""
        idx = self.label_id_to_idx.get(x)
        if idx is None:
            raise KeyError(
                f"label id {x} from the dataset has no row in the "
                f"description CSV ({len(self.label_id_to_idx)} classes "
                "loaded) — dataset and descriptions file do not match")
        return idx


def load_descriptions(descr_path: str, wv_type: str, wv_dim: int,
                      glove_path: Optional[str] = None,
                      fake_seed: int = 0) -> DescriptionPack:
    """End-to-end description loading — read_data -> embed -> cbow -> pack
    (the reference's run() wiring, model.py:1066-1104).

    ``wv_type="fake"`` substitutes deterministic random word vectors (the
    reference's only built-in fixture, model.py:1067-1069) while keeping the
    real CSV/token pipeline.
    """
    descr, word_dict, _, label_id_to_idx, idx_to_label = read_data(descr_path)
    if wv_type == "glove.6B":
        word_dict = embed(word_dict, glove_path)
    elif wv_type == "fake":
        word_dict = fake_embed(word_dict, wv_dim, seed=fake_seed)
    else:
        raise NotImplementedError(f"wv_type={wv_type}")
    descr = cbow(descr, word_dict)
    keys = list(descr.keys())
    desc = np.stack([descr[i]["cbow"] for i in keys], 0)
    desc_set = np.concatenate(
        [descr[i]["set"].reshape(-1, wv_dim) for i in keys], 0)
    desc_set_lens = [len(descr[i]["desc"]) for i in keys]
    return DescriptionPack(desc, desc_set, desc_set_lens,
                           label_id_to_idx, idx_to_label)

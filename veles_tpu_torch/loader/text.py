"""Token-corpus loaders for language-model workflows.

Port of ``veles_tpu/loader/text.py``: a sample is one ``[seq_len + 1]``
int32 token window (inputs and shifted targets, the layout of
``TransformerTrainer.step``), and the whole window table is a
full-batch dataset gathered on the device. The synthetic corpus comes
from numpy's generator, so its windows are bitwise the reference's for
one seed.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


class TokenWindowLoader(FullBatchLoader):
    """Cuts a 1-D token corpus into non-overlapping ``seq_len + 1``
    windows and serves them as minibatch_data ``[mbs, seq_len + 1]``
    int32. Subclasses implement :meth:`load_corpus`.

    kwargs: ``seq_len`` (window = seq_len + 1 tokens),
    ``valid_ratio`` (fraction of windows held out as VALID, default
    0.1; the VALID windows are the corpus head so resume/restart
    serves identical splits)."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.seq_len: int = kwargs.pop("seq_len", 64)
        self.valid_ratio: float = kwargs.pop("valid_ratio", 0.1)
        kwargs.setdefault("normalization_type", "none")
        super().__init__(workflow, **kwargs)

    def load_corpus(self) -> np.ndarray:
        raise NotImplementedError(
            "subclasses return the 1-D int token corpus")

    def load_data(self) -> None:
        corpus = np.asarray(self.load_corpus()).ravel()
        window = self.seq_len + 1
        n = len(corpus) // window
        if n < 2:
            raise ValueError(
                "corpus of %d tokens yields %d windows of %d — need "
                "at least 2" % (len(corpus), n, window))
        data = np.ascontiguousarray(
            corpus[:n * window].reshape(n, window).astype(np.int32))
        n_valid = int(n * self.valid_ratio)
        self.original_data = data
        self.has_labels = False
        self.class_lengths = [0, n_valid, n - n_valid]


class SyntheticTextLoader(TokenWindowLoader):
    """Learnable synthetic corpus: a random motif tiled with token
    noise — the LM task analogue of the synthetic digit set
    (loader/datasets.py), for tests and the CLI rung without network
    egress.

    kwargs: ``vocab`` (default 64), ``motif_len`` (default 16),
    ``n_tokens`` (default 32768), ``noise`` (substitution probability,
    default 0.05), ``corpus_seed``."""

    MAPPING = "synthetic_text"
    MAPPING_GROUP = "loader"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.vocab: int = kwargs.pop("vocab", 64)
        self.motif_len: int = kwargs.pop("motif_len", 16)
        self.n_tokens: int = kwargs.pop("n_tokens", 32768)
        self.noise: float = kwargs.pop("noise", 0.05)
        self.corpus_seed: int = kwargs.pop("corpus_seed", 7)
        super().__init__(workflow, **kwargs)

    def load_corpus(self) -> np.ndarray:
        rng = np.random.default_rng(self.corpus_seed)
        motif = rng.integers(0, self.vocab, self.motif_len)
        reps = self.n_tokens // self.motif_len + 1
        corpus = np.tile(motif, reps)[:self.n_tokens]
        flips = rng.random(self.n_tokens) < self.noise
        corpus[flips] = rng.integers(0, self.vocab, int(flips.sum()))
        return corpus

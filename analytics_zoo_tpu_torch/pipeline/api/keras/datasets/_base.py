"""Shared helpers of the offline dataset loaders (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets/_base.py``)."""

from __future__ import annotations

import os

import numpy as np

from analytics_zoo_tpu_torch.common.nncontext import logger

DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".zoo", "dataset")


def cache_path(dest_dir: str, name: str) -> str:
    return os.path.join(os.path.expanduser(dest_dir), name)


def synthetic_notice(dataset: str, why: str) -> None:
    logger.warning(
        "datasets.%s: %s — generating a deterministic SYNTHETIC "
        "stand-in (real shapes/dtypes, fake content). Place the "
        "reference cache file locally to use real data.", dataset, why)


def synthetic_sequences(n, vocab, seed, mean_len=120, max_len=400):
    """Ragged int index sequences like the imdb/reuters pickles."""
    rs = np.random.RandomState(seed)
    lengths = np.clip(rs.poisson(mean_len, size=n), 8, max_len)
    # skewed unigram distribution: low indices frequent, like
    # frequency-ordered word indices
    return [list(np.minimum(
        rs.zipf(1.3, size=int(ln)) + 3, vocab - 1).astype(np.int64))
        for ln in lengths]


def apply_nb_words(seqs, nb_words, oov_char):
    """The reference's vocabulary truncation contract
    (`imdb.py:40-76`): indices >= nb_words become ``oov_char``, or are
    dropped when ``oov_char`` is None."""
    if nb_words is None:
        return seqs
    if oov_char is not None:
        return [[w if w < nb_words else oov_char for w in s]
                for s in seqs]
    return [[w for w in s if w < nb_words] for s in seqs]

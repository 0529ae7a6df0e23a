"""Reuters newswire topic loader (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets/reuters.py``).

Reads a cached ``reuters.npz``/``reuters.pkl`` when present, else a
seeded synthetic stand-in with the dataset's 46 topic classes.
``test_split`` partitions the training set like the reference
(`reuters.py:40-78`).
"""

from __future__ import annotations

import io
import os
import zipfile

import numpy as np

from analytics_zoo_tpu_torch.common.safe_pickle import (
    CheckedUnpickler, UnsafePickleError)
from analytics_zoo_tpu_torch.pipeline.api.keras.datasets._base import (
    DEFAULT_DIR, apply_nb_words, cache_path, synthetic_notice,
    synthetic_sequences)

_VOCAB = 30980
_CLASSES = 46


def _load_legacy_npz(path):
    """One-time migration of a legacy object-array ``reuters.npz``
    (the format this repo wrote before the flat+offsets scheme).

    `np.load(allow_pickle=True)` would run unrestricted pickle; an
    object-dtype ``.npy`` member is just a header followed by a pickle
    stream, so the stream is fed through `CheckedUnpickler` instead —
    same whitelist as every other cache this repo reads. Returns
    ``(xs, ys)`` or None if the file is not a legacy cache."""
    from numpy.lib import format as npy_format

    def member(zf, name):
        with zf.open(name) as f:
            version = npy_format.read_magic(f)
            read_header = {          # public per-version readers only
                (1, 0): npy_format.read_array_header_1_0,
                (2, 0): npy_format.read_array_header_2_0,
            }.get(version)
            if read_header is None:
                raise ValueError(f"unsupported npy version {version}")
            _, _, dtype = read_header(f)
            if dtype.hasobject:
                return CheckedUnpickler(f).load()
            f2 = io.BytesIO(zf.read(name))
            return np.lib.format.read_array(f2, allow_pickle=False)

    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if not {"x.npy", "y.npy"} <= names:
                return None
            xs = [list(map(int, seq)) for seq in member(zf, "x.npy")]
            ys = [int(v) for v in np.asarray(member(zf, "y.npy"))]
            return xs, ys
    except UnsafePickleError:
        # a security rejection must be distinguishable from a merely
        # stale cache — surface it, don't fold into the format warning
        from analytics_zoo_tpu_torch.common.nncontext import logger
        logger.error(
            "datasets.reuters: legacy cache %s contains a pickle "
            "payload outside the deserialization whitelist — "
            "REFUSING to load it (tampered or foreign file?)", path)
        return None
    except (zipfile.BadZipFile, KeyError, ValueError, TypeError,
            OSError):
        return None


def _save_flat_npz(path, xs, ys):
    off = np.cumsum([0] + [len(s) for s in xs])
    flat = np.concatenate([np.asarray(s, np.int64) for s in xs]) \
        if off[-1] else np.zeros((0,), np.int64)
    tmp = path + ".tmp.npz"  # .npz suffix stops np.savez renaming it
    try:                     # atomic replace: a crash mid-write must
        np.savez(tmp, x_flat=flat, x_off=off,   # not leave a
                 y=np.asarray(ys, np.int64))    # truncated cache
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_data(dest_dir=DEFAULT_DIR, nb_words=None, oov_char=2,
              test_split=0.2):
    npz = cache_path(dest_dir, "reuters.npz")
    pkl = cache_path(dest_dir, "reuters.pkl")
    xs = None
    bad_npz = False
    if os.path.exists(npz):
        # Ragged sequences are stored flat (x_flat) + offsets (x_off)
        # so the npz never contains object arrays and loads with
        # allow_pickle=False — object-array caches would need
        # unrestricted pickle, which the repo's CheckedUnpickler
        # policy forbids.
        try:
            with np.load(npz, allow_pickle=False) as f:
                flat, off = f["x_flat"], f["x_off"]
                xs = [list(flat[off[i]:off[i + 1]])
                      for i in range(len(off) - 1)]
                ys = list(f["y"])
        except (KeyError, ValueError, OSError,
                zipfile.BadZipFile):  # truncated/foreign file →
            bad_npz = True            # legacy probe, then synthetic
            xs = None
    if bad_npz:
        from analytics_zoo_tpu_torch.common.nncontext import logger
        legacy = _load_legacy_npz(npz)
        if legacy is not None:
            xs, ys = legacy
            try:             # migrate in place to flat+offsets
                _save_flat_npz(npz, xs, ys)
                logger.info(
                    "datasets.reuters: migrated legacy object-array "
                    "cache %s to the flat+offsets format", npz)
            except OSError:
                pass         # read-only cache dir: converted in memory
        else:
            logger.warning(
                "datasets.reuters: cache %s is not in the flat+offsets "
                "format and was ignored; re-save it with "
                "x_flat=concat(seqs), x_off=cumsum([0]+lengths), "
                "y=labels", npz)
    if xs is None and os.path.exists(pkl):
        with open(pkl, "rb") as f:
            xs, ys = CheckedUnpickler(f).load()
    if xs is None:
        if not bad_npz:
            synthetic_notice("reuters", f"no cache at {npz}")
        xs = synthetic_sequences(640, _VOCAB, seed=20, mean_len=80)
        ys = list(np.random.RandomState(21).randint(
            0, _CLASSES, size=len(xs)))
    xs = apply_nb_words(xs, nb_words, oov_char)
    n_test = int(len(xs) * test_split)
    x_train, y_train = xs[n_test:], ys[n_test:]
    x_test, y_test = xs[:n_test], ys[:n_test]
    return (x_train, y_train), (x_test, y_test)

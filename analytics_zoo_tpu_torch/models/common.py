"""Model-zoo base classes (port of ``analytics_zoo_tpu/models/common.py``):
``ZooModel`` (hyperparameters, a lazily built net, the training surface
and persistence) and ``Ranker`` (NDCG@k and MAP over grouped scores).

Saved models and weight files hold numpy arrays, so a model saved on
the card loads on the CPU and the other way round."""

from __future__ import annotations

import importlib
import os
import pickle
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.bridge import params_to_numpy
from analytics_zoo_tpu_torch.common.safe_pickle import checked_load
from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet

_PACKAGE = "analytics_zoo_tpu_torch"


class ZooModel:
    """Container for a built-in model: holds hyperparameters, builds
    the net on first use, and routes the training surface to it."""

    def __init__(self):
        self._model: Optional[KerasNet] = None

    # -- to implement -------------------------------------------------------
    def build_model(self) -> KerasNet:
        raise NotImplementedError

    def hyper_parameters(self) -> dict:
        """Constructor kwargs needed to rebuild this model."""
        return {}

    # -- common surface -----------------------------------------------------
    @property
    def model(self) -> KerasNet:
        if self._model is None:
            self._model = self.build_model()
        return self._model

    def compile(self, optimizer="adam", loss="mse", metrics=None):
        self.model.compile(optimizer=optimizer, loss=loss, metrics=metrics)
        return self

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            **kwargs):
        return self.model.fit(x, y, batch_size=batch_size,
                              nb_epoch=nb_epoch, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32):
        return self.model.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        return self.model.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        return self.model.predict_classes(
            x, batch_size=batch_size, zero_based_label=zero_based_label)

    def summary(self):
        """The net's :meth:`~KerasNet.summary`, with param counts once
        it is compiled and built."""
        est = getattr(self.model, "_estimator", None)
        params = est.params if est is not None else None
        return self.model.summary(params)

    def _initialized_estimator(self):
        est = self.model.estimator
        if est.params is None:
            est._ensure_initialized()
        return est

    # -- persistence --------------------------------------------------------
    def save_model(self, path: str, over_write: bool = False):
        """Save the class, its hyperparameters and the weights (numpy);
        reload with ``<Class>.load_model(path)``."""
        if os.path.exists(path) and not over_write:
            raise FileExistsError(f"{path} exists; pass over_write=True")
        self._initialized_estimator()
        state = {
            "class": type(self).__name__,
            "module": type(self).__module__,
            "hyper_parameters": self.hyper_parameters(),
            "params": params_to_numpy(self.model),
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def load_model(cls, path: str) -> "ZooModel":
        """Rebuild a :meth:`save_model` file: read through the class
        whitelist, refuse a class outside this package or not a
        ``ZooModel``, compile with the defaults (the caller may compile
        again) and load the weights, shapes checked, on the context's
        device."""
        state = checked_load(path)
        mod_name = str(state["module"])
        if mod_name != _PACKAGE and not mod_name.startswith(_PACKAGE + "."):
            raise ValueError(
                f"saved model class {state['module']}.{state['class']} "
                "is not a framework model (tampered file?)")
        klass = getattr(importlib.import_module(mod_name), state["class"])
        if not (isinstance(klass, type) and issubclass(klass, ZooModel)):
            raise ValueError(
                f"{state['module']}.{state['class']} is not a ZooModel "
                "subclass (tampered file?)")
        inst = klass(**state["hyper_parameters"])
        inst.compile()
        _check_params_compatible(inst.model, state["params"])
        inst.model.estimator.params = state["params"]
        return inst

    # -- weight files -------------------------------------------------------
    def save_weights(self, path: str):
        """Write the weights as a flat ``.npz`` of ``"layer/param"``
        keys (the JAX package's format: each loads the other's)."""
        self._initialized_estimator()
        self.model.save_weights(path)

    def load_weights(self, path: str):
        """Load a :meth:`save_weights` file, every tensor's shape
        checked; a missing, unused or misshapen tensor raises. The
        optimizer's moments belonged to the old weights: the next
        ``fit`` starts them again."""
        est = self._initialized_estimator()
        params = params_to_numpy(self.model)
        with np.load(path) as data:
            saved = {k: data[k] for k in data.files}

        def walk(prefix, d):
            for k, v in list(d.items()):
                key = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(key, v)
                    continue
                if key not in saved:
                    raise KeyError(
                        f"weights file {path} is missing tensor "
                        f"{key!r} (wrong architecture?)")
                w = saved.pop(key)
                if tuple(w.shape) != tuple(np.shape(v)):
                    raise ValueError(
                        f"{key}: file shape {tuple(w.shape)} does not "
                        f"match model {tuple(np.shape(v))}")
                d[k] = w

        walk("", params)
        if saved:
            raise ValueError(
                f"weights file {path} has {len(saved)} unused tensors "
                f"(e.g. {sorted(saved)[:3]}) — wrong architecture?")
        est.params = params
        est.opt_state = None
        return self


def _check_params_compatible(model: KerasNet, saved: dict) -> None:
    """Layer names are a function of the architecture
    (``KerasNet._canonicalize_names``), so saved params must name this
    model's layers exactly."""
    expected = {lyr.name for lyr in model.layers}
    got = set(saved)
    if expected != got:
        raise ValueError(
            "checkpoint does not match model architecture; missing "
            f"layers {sorted(expected - got)}, unexpected "
            f"{sorted(got - expected)}")


class ImportedZooModel(ZooModel):
    """The ZooModel surface over a net imported from an external
    artifact (a BigDL ``.model``: the artifact defines the
    architecture). ``build_model`` imports ``artifact`` again, so
    ``save_model``/``load_model`` round trips work while the artifact
    stays in place (the saved weights are shape-checked against the
    imported net)."""

    def __init__(self, artifact: str, model_name: str = "imported",
                 net: Optional[KerasNet] = None):
        super().__init__()
        self.artifact = str(artifact)
        self.model_name = str(model_name)
        self._model = net

    def build_model(self) -> KerasNet:
        from analytics_zoo_tpu_torch.pipeline.api.net_load import Net
        return Net.load_bigdl(self.artifact)

    def hyper_parameters(self) -> dict:
        return {"artifact": self.artifact, "model_name": self.model_name}


class Ranker:
    """Ranking evaluation mixin: NDCG@k and MAP over grouped (query,
    candidates) relation lists, on the host."""

    @staticmethod
    def _group_scores(scores: np.ndarray, labels: np.ndarray,
                      group_ids: np.ndarray):
        order = np.argsort(group_ids, kind="stable")
        scores, labels, gids = scores[order], labels[order], group_ids[order]
        boundaries = np.flatnonzero(np.diff(gids)) + 1
        return (np.split(scores, boundaries), np.split(labels, boundaries))

    def evaluate_ndcg(self, scores, labels, group_ids, k: int = 3) -> float:
        """Mean NDCG@k over query groups."""
        s_groups, l_groups = self._group_scores(
            np.asarray(scores).reshape(-1), np.asarray(labels).reshape(-1),
            np.asarray(group_ids).reshape(-1))
        vals = []
        for s, l in zip(s_groups, l_groups):
            order = np.argsort(-s)[:k]
            gains = (2.0 ** l[order] - 1.0) / \
                np.log2(np.arange(2, len(order) + 2))
            ideal_order = np.argsort(-l)[:k]
            ideal = (2.0 ** l[ideal_order] - 1.0) / \
                np.log2(np.arange(2, len(ideal_order) + 2))
            denom = ideal.sum()
            if denom > 0:
                vals.append(gains.sum() / denom)
        return float(np.mean(vals)) if vals else 0.0

    def evaluate_map(self, scores, labels, group_ids) -> float:
        """Mean average precision over query groups."""
        s_groups, l_groups = self._group_scores(
            np.asarray(scores).reshape(-1), np.asarray(labels).reshape(-1),
            np.asarray(group_ids).reshape(-1))
        aps = []
        for s, l in zip(s_groups, l_groups):
            order = np.argsort(-s)
            rel = (l[order] > 0).astype(np.float64)
            if rel.sum() == 0:
                continue
            precision_at = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            aps.append((precision_at * rel).sum() / rel.sum())
        return float(np.mean(aps)) if aps else 0.0

"""Versioned model registry and canary rollout (port of
``analytics_zoo_tpu/pipeline/inference/registry.py``).

- :class:`ModelRegistry`: ``name -> version -> ModelVersion``, persisted
  as a directory tree a fleet can share (or held in memory);
- :class:`ModelVersion`: one immutable entry; :meth:`~ModelVersion.
  load_into` warm-swaps it into a live :class:`InferenceModel` (its
  ``generation`` bumps, so each replica's batcher makes its bucket
  callables anew);
- :class:`RolloutController`: the state machine behind
  ``FleetRouter.rollout(version, canary_pct=)``::

      rolling --> canary --> promoting --> promoted
                    |
                    +--(cohort SLO breach / error burst)-->
                        rolling_back --> rolled_back

  Rolling forward drains one replica at a time behind the router (the
  drain flushes its queue, so no acked request drops), loads the new
  version and restarts it. The canary phase then routes ``canary_pct``%
  of traffic to the new version through the router's cohort split while
  a cohort-scoped error-ratio objective (installed by the controller,
  removed when the rollout ends) watches
  ``zoo_tpu_rollout_errors_total{version}`` against
  ``zoo_tpu_rollout_requests_total{version}``. An ``slo_breach`` on it,
  or a burst of ``max_canary_errors`` cohort errors, rolls back through
  the same drain path; a clean bake of ``bake_s`` promotes.

Every transition appends a ``rollout/state`` event and counts in
``zoo_tpu_rollout_transitions_total{state}``; the swaps are spanned
(``rollout/swap_replica`` and the rest) and ``GET /debug/rollout`` shows
the state.

A version is an ``InferenceModel.export_compiled`` artifact (a zip,
persisted under the registry's root) or an in-memory loader callable:
:meth:`ModelVersion.load_into` loads the first through
``InferenceModel.load_compiled`` and calls the second, and
:meth:`ModelRegistry.register_export` exports a live model into the
registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from analytics_zoo_tpu_torch.common import diagnostics
from analytics_zoo_tpu_torch.common import observability as obs
from analytics_zoo_tpu_torch.common import slo as slo_mod
from analytics_zoo_tpu_torch.common.nncontext import logger

__all__ = [
    "ModelVersion",
    "ModelRegistry",
    "RolloutController",
]

# rollout lifecycle states (GET /debug/rollout)
ROLLING = "rolling"
CANARY = "canary"
PROMOTING = "promoting"
PROMOTED = "promoted"
ROLLING_BACK = "rolling_back"
ROLLED_BACK = "rolled_back"

_META_FILE = "meta.json"
_ARTIFACT_FILE = "artifact.zip"


def _c_transitions(state: str):
    return obs.counter("zoo_tpu_rollout_transitions_total",
                       help="rollout state-machine transitions, "
                            "by entered state",
                       labels={"state": state})


def _g_active():
    return obs.gauge("zoo_tpu_rollout_active",
                     help="1 while a rollout is in progress")


class ModelVersion:
    """One immutable registry entry: a named version of a model,
    backed by an on-disk ``export_compiled`` artifact OR an
    in-memory ``loader(model)`` callable (tests, smokes, and
    processes that build params in place)."""

    def __init__(self, model_name: str, name: str,
                 artifact: Optional[str] = None,
                 loader: Optional[Callable] = None,
                 metadata: Optional[dict] = None,
                 warm_buckets: Optional[List[int]] = None,
                 created_at: Optional[float] = None,
                 registry: "Optional[ModelRegistry]" = None):
        if (artifact is None) == (loader is None):
            raise ValueError(
                "a ModelVersion needs exactly one of artifact= "
                "(export_compiled path) or loader= (callable)")
        self.model_name = str(model_name)
        self.name = str(name)
        self.artifact = artifact
        self.loader = loader
        self.metadata = dict(metadata or {})
        self.warm_buckets = (list(warm_buckets)
                             if warm_buckets else None)
        self.created_at = (time.time() if created_at is None
                           else float(created_at))
        self.registry = registry

    def load_into(self, model) -> None:
        """Warm-swap this version into a live
        :class:`~analytics_zoo_tpu_torch.pipeline.inference.
        inference_model.InferenceModel`: an artifact version through
        ``load_compiled`` (its programs, no model code), a loader version
        by calling its callable, which must bump ``model.generation`` (a
        ``load_keras_net`` does). Either way the batchers serving the
        model make their bucket callables anew."""
        with obs.span("rollout/swap", model=self.model_name,
                      version=self.name):
            if self.loader is not None:
                self.loader(model)
            else:
                model.load_compiled(self.artifact)
        obs.event("rollout/version_loaded", model=self.model_name,
                  version=self.name)

    def to_dict(self) -> dict:
        return {
            "model": self.model_name,
            "version": self.name,
            "artifact": self.artifact,
            "in_memory": self.loader is not None,
            "metadata": self.metadata,
            "warm_buckets": self.warm_buckets,
            "created_at": self.created_at,
        }

    def __repr__(self):
        src = "loader" if self.loader is not None else self.artifact
        return (f"ModelVersion({self.model_name}:{self.name}, "
                f"{src})")


class ModelRegistry:
    """``name → version → ModelVersion``, optionally persisted under
    ``root`` as ``<root>/<model>/<version>/{meta.json,
    artifact.zip}`` (``ZOO_TPU_MODEL_REGISTRY`` names a default
    root). Version order is registration order (on disk:
    ``created_at``); :meth:`latest` returns the newest. In-memory
    (loader-backed) versions never persist — they exist for the
    lifetime of the process that registered them."""

    def __init__(self, root: Optional[str] = None):
        if root is None:
            root = os.environ.get("ZOO_TPU_MODEL_REGISTRY") or None
        self.root = root
        self._lock = threading.Lock()
        self._models: "Dict[str, Dict[str, ModelVersion]]" = {}
        if self.root:
            os.makedirs(self.root, exist_ok=True)
            self._scan()

    # -- persistence ---------------------------------------------------------
    def _scan(self):
        """Rebuild the index from the on-disk tree (crash-safe: a
        version directory without ``meta.json`` is an unfinished
        registration and is skipped)."""
        for model in sorted(os.listdir(self.root)):
            mdir = os.path.join(self.root, model)
            if not os.path.isdir(mdir):
                continue
            for version in sorted(os.listdir(mdir)):
                vdir = os.path.join(mdir, version)
                meta_path = os.path.join(vdir, _META_FILE)
                if not os.path.isfile(meta_path):
                    continue
                try:
                    with open(meta_path) as f:
                        meta = json.load(f)
                except (OSError, ValueError) as e:
                    logger.warning(
                        "registry: skipping unreadable %s (%s)",
                        meta_path, e)
                    continue
                artifact = os.path.join(
                    vdir, meta.get("artifact_file", _ARTIFACT_FILE))
                mv = ModelVersion(
                    model, version, artifact=artifact,
                    metadata=meta.get("metadata"),
                    warm_buckets=meta.get("warm_buckets"),
                    created_at=meta.get("created_at"),
                    registry=self)
                self._models.setdefault(model, {})[version] = mv

    def _persist(self, mv: ModelVersion, src_artifact: str):
        """Write ``<root>/<model>/<version>/`` atomically enough for
        :meth:`_scan`: the artifact lands first, ``meta.json`` last
        (tmp + ``os.replace``) — a half-registered version is
        invisible."""
        vdir = os.path.join(self.root, mv.model_name, mv.name)
        os.makedirs(vdir, exist_ok=True)
        dst = os.path.join(vdir, _ARTIFACT_FILE)
        if os.path.abspath(src_artifact) != os.path.abspath(dst):
            tmp = dst + ".tmp"
            with open(src_artifact, "rb") as fin, \
                    open(tmp, "wb") as fout:
                fout.write(fin.read())
            os.replace(tmp, dst)
        mv.artifact = dst
        meta = {"artifact_file": _ARTIFACT_FILE,
                "metadata": mv.metadata,
                "warm_buckets": mv.warm_buckets,
                "created_at": mv.created_at}
        tmp = os.path.join(vdir, _META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
        os.replace(tmp, os.path.join(vdir, _META_FILE))

    # -- registration --------------------------------------------------------
    def register(self, model_name: str, version: str,
                 artifact: Optional[str] = None,
                 loader: Optional[Callable] = None,
                 metadata: Optional[dict] = None,
                 warm_buckets: Optional[List[int]] = None
                 ) -> ModelVersion:
        """Register one version. ``artifact`` is an
        ``export_compiled`` zip (copied under the registry root when
        one is configured); ``loader`` is an in-memory alternative
        (``loader(model)`` must leave ``model`` serving the new
        version). Re-registering an existing version is an error —
        versions are immutable (publish a new name instead)."""
        mv = ModelVersion(model_name, version, artifact=artifact,
                          loader=loader, metadata=metadata,
                          warm_buckets=warm_buckets, registry=self)
        with self._lock:
            versions = self._models.setdefault(str(model_name), {})
            if str(version) in versions:
                raise ValueError(
                    f"version {model_name}:{version} already "
                    f"registered (versions are immutable)")
            if self.root and artifact is not None:
                self._persist(mv, artifact)
            versions[str(version)] = mv
        obs.event("rollout/version_registered", model=model_name,
                  version=version,
                  in_memory=loader is not None)
        return mv

    def register_export(self, model_name: str, version: str,
                        model, metadata: Optional[dict] = None,
                        warm_buckets: Optional[List[int]] = None
                        ) -> ModelVersion:
        """Export a live :class:`InferenceModel`'s serving program
        (``export_compiled``) straight into the registry (which needs a
        ``root``). The warm-bucket manifest defaults to the bucket ladder
        a replica would warm for it (``ZOO_TPU_SERVING_MAX_BATCH``)."""
        if not self.root:
            raise ValueError(
                "register_export needs a registry root directory")
        if warm_buckets is None:
            from analytics_zoo_tpu_torch.pipeline.inference.batching \
                import bucket_ladder
            cap = int(os.environ.get("ZOO_TPU_SERVING_MAX_BATCH", 32))
            warm_buckets = list(bucket_ladder(cap))
        vdir = os.path.join(self.root, str(model_name), str(version))
        os.makedirs(vdir, exist_ok=True)
        artifact = os.path.join(vdir, _ARTIFACT_FILE)
        model.export_compiled(artifact)
        return self.register(model_name, version, artifact=artifact,
                             metadata=metadata, warm_buckets=warm_buckets)

    # -- lookup --------------------------------------------------------------
    def get(self, model_name: str, version: str) -> ModelVersion:
        with self._lock:
            try:
                return self._models[str(model_name)][str(version)]
            except KeyError:
                raise KeyError(
                    f"no version {model_name}:{version} in the "
                    f"registry") from None

    def latest(self, model_name: str) -> ModelVersion:
        with self._lock:
            versions = self._models.get(str(model_name))
            if not versions:
                raise KeyError(
                    f"no model {model_name!r} in the registry")
            return max(versions.values(),
                       key=lambda v: v.created_at)

    def versions(self, model_name: str) -> "List[str]":
        with self._lock:
            vs = self._models.get(str(model_name), {})
            return [v.name for v in sorted(
                vs.values(), key=lambda v: v.created_at)]

    def models(self) -> "List[str]":
        with self._lock:
            return sorted(self._models)

    def status(self) -> dict:
        """JSON-able index dump (debug surfaces)."""
        with self._lock:
            return {
                "root": self.root,
                "models": {
                    m: [v.to_dict() for v in sorted(
                        vs.values(), key=lambda v: v.created_at)]
                    for m, vs in self._models.items()},
            }

    def __repr__(self):
        with self._lock:
            counts = {m: len(vs)
                      for m, vs in self._models.items()}
        return f"ModelRegistry(root={self.root!r}, {counts})"


class RolloutController:
    """Drives one rollout of ``version`` across a
    :class:`~analytics_zoo_tpu_torch.pipeline.inference.fleet.FleetRouter`'s
    fleet (state machine in the module docstring). Constructed by
    ``FleetRouter.rollout``; the router's prober thread (or a manual
    ``router.tick()``) drives :meth:`tick`.

    ``canary_pct`` picks both the replica share swapped first and
    the traffic share routed to them; ``<= 0`` means a plain rolling
    update (every replica swapped, no canary watch), ``>= 100``
    swaps everything but still bakes before declaring ``promoted``.
    ``bake_s`` is the clean-canary dwell before promotion,
    ``max_canary_errors`` the raw cohort error burst that rolls back
    without waiting for the SLO engine (the SLO — objective
    ``slo_objective``, windows ``slo_windows`` — needs traffic
    deltas between engine ticks; the burst check catches a
    fault-storm between them)."""

    def __init__(self, router, version, canary_pct: int = 25,
                 baseline=None, bake_s: float = 30.0,
                 max_canary_errors: Optional[int] = 10,
                 slo_objective: float = 0.95,
                 slo_burn_rate: float = 1.0,
                 slo_windows=(30.0, 120.0),
                 slo_min_events: int = 5,
                 drain_timeout: float = 30.0,
                 engine: "Optional[slo_mod.SLOEngine]" = None):
        self.router = router
        self.version = version
        self.version_name = str(getattr(version, "name", version))
        self.canary_pct = int(canary_pct)
        self.bake_s = float(bake_s)
        self.max_canary_errors = max_canary_errors
        self.slo_objective = float(slo_objective)
        self.slo_burn_rate = float(slo_burn_rate)
        self.slo_windows = tuple(slo_windows)
        self.slo_min_events = int(slo_min_events)
        self.drain_timeout = float(drain_timeout)
        self._engine = engine
        self._explicit_baseline = baseline
        self.baseline = None  # ModelVersion, resolved at begin()
        self.baseline_name: Optional[str] = None
        self.state = "idle"
        self.reason: Optional[str] = None
        self.transitions: "List[dict]" = []
        self.swaps: "List[dict]" = []
        self.canary_replicas: "List[str]" = []
        self.canary_since: Optional[float] = None
        self._err_base = 0.0
        self._breach_reason: Optional[str] = None
        self._clock = router.pool.clock
        self._lock = threading.RLock()
        self._slo_id = "rollout_canary"
        self._listener_installed = False

    # -- state machine -------------------------------------------------------
    @property
    def in_progress(self) -> bool:
        return self.state in (ROLLING, CANARY, PROMOTING,
                              ROLLING_BACK)

    def _transition(self, state: str, **fields):
        self.state = state
        rec = {"state": state, "at": self._clock()}
        rec.update(fields)
        self.transitions.append(rec)
        _c_transitions(state).inc()
        _g_active().set(1 if self.in_progress else 0)
        obs.event("rollout/state", version=self.version_name,
                  state=state, **fields)
        logger.info("rollout %s -> %s %s", self.version_name,
                    state, fields or "")

    def begin(self):
        """Resolve the baseline, swap the canary share of replicas
        (one drained at a time), and either enter the canary watch
        or — for a plain rolling update — run straight through to
        ``promoted``."""
        with self._lock:
            if self.state != "idle":
                raise RuntimeError(
                    f"rollout already began (state={self.state})")
            replicas = [r for r in self.router.pool.replicas
                        if r.state != "down"]
            if not replicas:
                raise RuntimeError("no live replica to roll")
            swappable = [r for r in replicas
                         if getattr(r, "model", None) is not None]
            if len(swappable) != len(replicas):
                bad = [r.name for r in replicas
                       if r not in swappable]
                raise ValueError(
                    f"replicas {bad} are not in-process; warm-swap "
                    f"rollout needs replicas owning their model")
            self.baseline_name = swappable[0].version
            self._resolve_baseline()
            pct = self.canary_pct
            if pct <= 0 or pct >= 100:
                targets = list(swappable)
            else:
                k = max(1, round(len(swappable) * pct / 100.0))
                k = min(k, len(swappable) - 1) or 1
                targets = swappable[:k]
            self._transition(
                ROLLING, canary_pct=pct,
                targets=[r.name for r in targets],
                baseline=self.baseline_name)
            with obs.span("rollout/roll", version=self.version_name,
                          n=len(targets)):
                for r in targets:
                    self._swap(r, self.version)
            self.canary_replicas = [r.name for r in targets]
            if len(targets) == len(swappable):
                # plain rolling update: nothing left to compare the
                # canary against — declare it promoted
                self._finish(PROMOTED)
                return self
            self.router.set_canary(self.version_name,
                                   self.baseline_name, pct)
            self._err_base = self._cohort_errors()
            self.canary_since = self._clock()
            self._install_slo()
            self._transition(
                CANARY, pct=pct,
                canary_replicas=self.canary_replicas,
                bake_s=self.bake_s)
            return self

    def _resolve_baseline(self):
        """The version object rollback restores: explicit
        ``baseline=``, else looked up by the replicas' current
        version name in the registry the new version came from.
        Resolved BEFORE any replica is touched — a rollout that
        could not roll back must not start."""
        if self._explicit_baseline is not None:
            self.baseline = self._explicit_baseline
            self.baseline_name = str(getattr(
                self.baseline, "name", self.baseline))
            return
        reg = getattr(self.version, "registry", None)
        model_name = getattr(self.version, "model_name", None)
        if reg is not None and model_name is not None:
            try:
                self.baseline = reg.get(model_name,
                                        self.baseline_name)
                return
            except KeyError:
                pass
        raise ValueError(
            f"cannot resolve baseline version "
            f"{self.baseline_name!r} for rollback; register it or "
            f"pass baseline= to rollout()")

    def _swap(self, r, version):
        """One replica's warm swap: drain behind the router (queue
        flushed — zero dropped acked requests), load the version
        (generation bump), restart (re-warm, resume admitting)."""
        with obs.span("rollout/swap_replica", replica=r.name,
                      version=str(getattr(version, "name",
                                          version))):
            flushed = self.router.drain(
                r.name, timeout=self.drain_timeout)
            version.load_into(r.model)
            r.version = str(getattr(version, "name", version))
            self.router.restart_replica(r.name)
        self.swaps.append({"replica": r.name,
                           "version": r.version,
                           "flushed": bool(flushed),
                           "at": self._clock()})

    # -- canary watch --------------------------------------------------------
    def _cohort_errors(self) -> float:
        from analytics_zoo_tpu_torch.pipeline.inference.fleet import \
            _c_cohort_errors
        return float(_c_cohort_errors(self.version_name).value)

    def _install_slo(self):
        if self._engine is None:
            if not slo_mod.enabled():
                return
            self._engine = slo_mod.get_engine()
        rule = slo_mod.SLO(
            id=self._slo_id,
            description=(
                f"canary cohort {self.version_name} error ratio "
                f"stays within its {self.slo_objective:.0%} "
                f"objective"),
            signal={
                "type": "ratio",
                "numerator": {
                    "metric": "zoo_tpu_rollout_errors_total",
                    "labels": {"version": self.version_name}},
                "denominator": {
                    "metric": "zoo_tpu_rollout_requests_total",
                    "labels": {"version": self.version_name}},
            },
            objective=self.slo_objective,
            burn_rate=self.slo_burn_rate,
            windows=self.slo_windows,
            min_events=self.slo_min_events)
        self._engine.add(rule, replace=True)
        diagnostics.add_anomaly_listener(self._on_anomaly)
        self._listener_installed = True

    def _remove_slo(self):
        if self._listener_installed:
            diagnostics.remove_anomaly_listener(self._on_anomaly)
            self._listener_installed = False
        if self._engine is not None:
            self._engine.remove(self._slo_id)

    def _on_anomaly(self, kind: str, fields: dict):
        """Anomaly-pipeline hook: an ``slo_breach`` on the canary
        objective marks the rollout for rollback; the next
        :meth:`tick` (prober thread or manual) executes it — the
        listener itself must stay cheap, it runs inside whoever
        called ``engine.tick``."""
        if kind != "slo_breach":
            return
        if fields.get("slo") != self._slo_id:
            return
        self._breach_reason = (
            f"slo_breach on {self._slo_id}: "
            f"value={fields.get('value')}")

    def tick(self, now: Optional[float] = None) -> dict:
        """One canary-watch pass: roll back on a recorded SLO breach
        or a raw cohort error burst; promote after a clean
        ``bake_s``. No-op outside the canary phase."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.state != CANARY:
                return self.status()
            errs = self._cohort_errors() - self._err_base
            if (self.max_canary_errors is not None
                    and errs >= self.max_canary_errors):
                self._rollback_locked(
                    f"canary error burst: {errs:.0f} errors on "
                    f"cohort {self.version_name} (threshold "
                    f"{self.max_canary_errors})")
            elif self._breach_reason is not None:
                self._rollback_locked(self._breach_reason)
            elif now - self.canary_since >= self.bake_s:
                self._promote_locked()
            return self.status()

    def promote(self):
        """Manually promote a baking canary (operators who have seen
        enough; tests)."""
        with self._lock:
            if self.state != CANARY:
                raise RuntimeError(
                    f"nothing to promote (state={self.state})")
            self._promote_locked()
        return self

    def rollback(self, reason: str = "manual"):
        """Manually roll back a baking canary."""
        with self._lock:
            if self.state != CANARY:
                raise RuntimeError(
                    f"nothing to roll back (state={self.state})")
            self._rollback_locked(reason)
        return self

    def _promote_locked(self):
        self._transition(PROMOTING)
        rest = [r for r in self.router.pool.replicas
                if r.name not in self.canary_replicas
                and r.state != "down"]
        with obs.span("rollout/promote", version=self.version_name,
                      n=len(rest)):
            for r in rest:
                self._swap(r, self.version)
        self.router.clear_canary()
        self._finish(PROMOTED)

    def _rollback_locked(self, reason: str):
        self.reason = reason
        self._transition(ROLLING_BACK, reason=reason)
        # stop feeding the sick cohort FIRST, then unwind its
        # replicas through the same zero-drop drain path
        self.router.clear_canary()
        with obs.span("rollout/rollback",
                      version=self.version_name,
                      n=len(self.canary_replicas)):
            for name in self.canary_replicas:
                r = self.router._replica(name)
                self._swap(r, self.baseline)
        diagnostics.anomaly("rollout_rolled_back",
                            version=self.version_name,
                            reason=reason)
        self._finish(ROLLED_BACK, reason=reason)

    def _finish(self, state: str, **fields):
        self._remove_slo()
        self.canary_since = None
        self._transition(state, **fields)

    # -- introspection -------------------------------------------------------
    def status(self) -> dict:
        """JSON-able lifecycle dump — the live half of
        ``GET /debug/rollout``."""
        with self._lock:
            st = {
                "state": self.state,
                "version": self.version_name,
                "baseline": self.baseline_name,
                "canary_pct": self.canary_pct,
                "canary_replicas": list(self.canary_replicas),
                "bake_s": self.bake_s,
                "max_canary_errors": self.max_canary_errors,
                "slo_id": self._slo_id,
                "replica_versions": {
                    r.name: r.version
                    for r in self.router.pool.replicas},
                "swaps": list(self.swaps),
                "transitions": list(self.transitions),
            }
            if self.reason:
                st["reason"] = self.reason
            if self.canary_since is not None:
                st["canary_age_s"] = round(
                    self._clock() - self.canary_since, 3)
            return st

    def __repr__(self):
        return (f"RolloutController({self.version_name}, "
                f"state={self.state}, pct={self.canary_pct})")

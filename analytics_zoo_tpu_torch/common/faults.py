"""Fault injection for chaos testing (port of
``analytics_zoo_tpu/common/faults.py``).

A registry of named **injection points** compiled into the serving
code, each a guarded no-op until a test (or ``ZOO_TPU_FAULTS``) arms it
with a behavior::

    from analytics_zoo_tpu_torch.common import faults
    _FAULT = faults.point("generation/decode_step")   # module scope
    ...
    def step(self, active):
        _FAULT.fire()                                 # hot path
        ...

Unarmed, :meth:`FaultPoint.fire` is a single attribute test
(``self._spec is None``): no dict lookup, no lock, no allocation.

Behaviors (``kind``):

``error``    raise :class:`InjectedFaultError`
``kill``     raise :class:`InjectedKillError`: "the replica/process
             died"; callers treat it like any crash
``delay``    sleep ``seconds`` (a straggler), then continue
``wedge``    block until disarmed (or ``seconds`` elapse, default
             30 s): a stuck dispatcher or a hung device
``corrupt``  :meth:`FaultPoint.corrupt` returns a corrupted copy of
             the value (float arrays NaN-poisoned, integer arrays
             bit-flipped); ``fire`` is a no-op for this kind

Arming:

- from a test: ``faults.arm("batcher/dispatch", "error", times=1)``,
  ``faults.disarm(...)`` / ``faults.disarm_all()`` (both always safe);
- from the environment: ``ZOO_TPU_FAULTS="point=kind[:seconds][:key=
  val]..."``, ``;``-separated for several points, parsed once at the
  first query, e.g.::

      ZOO_TPU_FAULTS="generation/decode_step=kill:times=1;\
          batcher/dispatch=delay:0.2"

Selectors: ``times=N`` disarms after N firings, ``p=0.5`` fires with
that probability, ``where_<key>=value`` fires only when the site passed
``fire(<key>=value)``.

Points in the port: ``generation/decode_step`` (``GenerationEngine.step``
and ``spec_step``), ``batcher/dispatch`` (the head of every
``DynamicBatcher`` batch execution) and ``estimator/checkpoint_write``
(``Estimator.save_checkpoint``, between the pickle's bytes and the
rename).

Every firing increments ``zoo_tpu_faults_injected_total{point,kind}``
in :mod:`~analytics_zoo_tpu_torch.common.observability` and appends a
``faults/injected`` event to the ``ZOO_TPU_EVENT_LOG`` file; every
arming appends a ``faults/armed`` event.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from analytics_zoo_tpu_torch.common import observability as obs

__all__ = [
    "FaultPoint",
    "InjectedFaultError",
    "InjectedKillError",
    "point",
    "arm",
    "disarm",
    "disarm_all",
    "armed",
    "points",
]

_KINDS = ("error", "kill", "delay", "wedge", "corrupt")


class InjectedFaultError(RuntimeError):
    """An armed ``error`` fault fired at an injection point."""

    def __init__(self, point_name: str):
        super().__init__(f"injected fault at {point_name}")
        self.point = point_name


class InjectedKillError(InjectedFaultError):
    """An armed ``kill`` fault fired — simulates the owning
    component (replica, worker) dying mid-operation."""

    def __init__(self, point_name: str):
        RuntimeError.__init__(
            self, f"injected kill at {point_name}")
        self.point = point_name


class _Spec:
    """One armed behavior: kind + selectors + firing budget."""

    def __init__(self, kind: str, seconds: float = 0.0,
                 times: Optional[int] = None, p: float = 1.0,
                 where: Optional[Dict[str, str]] = None):
        if kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (one of {_KINDS})")
        self.kind = kind
        self.seconds = float(seconds)
        self.times = None if times is None else int(times)
        self.p = float(p)
        self.where = dict(where) if where else None
        self.fired = 0
        self.release = threading.Event()  # unwedges on disarm

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "fired": self.fired}
        if self.seconds:
            d["seconds"] = self.seconds
        if self.times is not None:
            d["times"] = self.times
        if self.p < 1.0:
            d["p"] = self.p
        if self.where:
            d["where"] = dict(self.where)
        return d


class FaultPoint:
    """A named injection point. Hold the object at module/class
    scope and call :meth:`fire` (or :meth:`corrupt` for output
    corruption) on the hot path — unarmed, both are a single
    attribute test."""

    __slots__ = ("name", "_spec")

    def __init__(self, name: str):
        self.name = name
        self._spec: Optional[_Spec] = None

    def fire(self, **ctx):
        """Execute the armed behavior, or return immediately when
        unarmed. ``ctx`` lets sites expose selectors (e.g.
        ``fire(replica=self.name)``) for ``where_*`` targeting."""
        if self._spec is None:  # the unarmed hot path: one test
            return
        self._fire_armed(ctx)

    def corrupt(self, value, **ctx):
        """Return ``value``, corrupted when an armed ``corrupt``
        fault fires (numeric numpy arrays are NaN-poisoned; integer
        arrays bit-flipped; anything else returned as-is with the
        firing still counted)."""
        if self._spec is None:
            return value
        spec = self._take(ctx, kinds=("corrupt",))
        if spec is None:
            return value
        self._count(spec)
        return _corrupt_value(value)

    # -- armed slow path -----------------------------------------------------
    def _take(self, ctx, kinds=None) -> Optional[_Spec]:
        """The armed spec iff its selectors match this firing (and
        its budget allows one more); None otherwise."""
        spec = self._spec
        if spec is None:
            return None
        if kinds is not None and spec.kind not in kinds:
            return None
        if kinds is None and spec.kind == "corrupt":
            return None  # corrupt only fires through corrupt()
        if spec.where:
            for k, v in spec.where.items():
                if str(ctx.get(k)) != v:
                    return None
        if spec.p < 1.0 and random.random() >= spec.p:
            return None
        if spec.times is not None:
            with _lock:
                if spec.times <= 0:
                    return None
                spec.times -= 1
                if spec.times == 0:
                    # budget spent: restore the no-op hot path
                    if self._spec is spec:
                        self._spec = None
                        spec.release.set()
        return spec

    def _count(self, spec: _Spec):
        spec.fired += 1
        obs.counter("zoo_tpu_faults_injected_total",
                    help="injected faults fired, by point and kind",
                    labels={"point": self.name,
                            "kind": spec.kind}).inc()
        obs.event("faults/injected", point=self.name, kind=spec.kind)

    def _fire_armed(self, ctx):
        spec = self._take(ctx)
        if spec is None:
            return
        self._count(spec)
        if spec.kind == "error":
            raise InjectedFaultError(self.name)
        if spec.kind == "kill":
            raise InjectedKillError(self.name)
        if spec.kind == "delay":
            time.sleep(spec.seconds)
            return
        if spec.kind == "wedge":
            # block until disarmed (release set) or the safety cap
            spec.release.wait(timeout=spec.seconds or 30.0)
            return

    # -- introspection -------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._spec is not None

    def status(self) -> dict:
        spec = self._spec
        return {"point": self.name,
                "armed": spec.to_dict() if spec else None}

    def __repr__(self):
        return f"FaultPoint({self.name!r}, armed={self.armed})"


def _corrupt_value(value):
    import numpy as np
    try:
        arr = np.asarray(value)
    except Exception:
        return value
    if arr.dtype.kind == "f":
        return np.full_like(arr, np.nan)
    if arr.dtype.kind in "iu":
        return arr ^ np.asarray(1, arr.dtype)
    return value


_lock = threading.Lock()
_points: "Dict[str, FaultPoint]" = {}
_env_parsed = False


def point(name: str) -> FaultPoint:
    """The (process-global) injection point named ``name``; created
    on first request. Env-armed faults (``ZOO_TPU_FAULTS``) attach
    the first time their point is created."""
    with _lock:
        fp = _points.get(name)
        if fp is None:
            fp = _points[name] = FaultPoint(name)
        _parse_env_locked()
    return fp


def arm(name: str, kind: str, seconds: float = 0.0,
        times: Optional[int] = None, p: float = 1.0,
        where: Optional[Dict[str, str]] = None) -> FaultPoint:
    """Arm ``name`` with a behavior (replacing any prior arming).
    See the module docstring for kinds and selectors."""
    fp = point(name)
    spec = _Spec(kind, seconds=seconds, times=times, p=p,
                 where=where)
    with _lock:
        old = fp._spec
        fp._spec = spec
        if old is not None:
            old.release.set()
    obs.event("faults/armed", point=name, kind=kind)
    return fp


def disarm(name: str):
    """Disarm ``name`` (releasing any wedged thread). Safe when the
    point does not exist or is already unarmed."""
    with _lock:
        fp = _points.get(name)
        if fp is None:
            return
        spec = fp._spec
        fp._spec = None
    if spec is not None:
        spec.release.set()


def disarm_all():
    """Disarm every point (test teardown)."""
    with _lock:
        specs = []
        for fp in _points.values():
            if fp._spec is not None:
                specs.append(fp._spec)
                fp._spec = None
    for spec in specs:
        spec.release.set()


def armed() -> "Dict[str, dict]":
    """``{point: spec_dict}`` for every currently armed point."""
    with _lock:
        return {name: fp._spec.to_dict()
                for name, fp in _points.items()
                if fp._spec is not None}


def points() -> "Dict[str, dict]":
    """Status of every registered injection point, armed or not."""
    with _lock:
        return {name: fp.status() for name, fp in _points.items()}


# -- ZOO_TPU_FAULTS grammar --------------------------------------------------

def _parse_env_locked():
    """Parse ``ZOO_TPU_FAULTS`` once per process and arm matching
    points as they are created. Grammar::

        spec      := entry (';' entry)*
        entry     := point '=' kind (':' param)*
        param     := float | 'times=' int | 'p=' float
                     | 'where_' key '=' value

    A bare float param is the behavior's ``seconds`` (delay/wedge).
    Malformed entries are skipped with a warning — a chaos flag must
    never take the process down."""
    global _env_parsed
    if _env_parsed:
        _arm_env_pending_locked()
        return
    _env_parsed = True
    raw = os.environ.get("ZOO_TPU_FAULTS", "")
    _ENV_SPECS.clear()
    if not raw:
        return
    from analytics_zoo_tpu_torch.common.nncontext import logger
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        try:
            name, rhs = entry.split("=", 1)
            parts = rhs.split(":")
            kind = parts[0].strip()
            kw: dict = {"seconds": 0.0, "times": None, "p": 1.0,
                        "where": {}}
            for param in parts[1:]:
                if param.startswith("times="):
                    kw["times"] = int(param[6:])
                elif param.startswith("p="):
                    kw["p"] = float(param[2:])
                elif param.startswith("where_"):
                    k, v = param[6:].split("=", 1)
                    kw["where"][k] = v
                else:
                    kw["seconds"] = float(param)
            _ENV_SPECS[name.strip()] = (kind, kw)
        except (ValueError, IndexError) as e:
            logger.warning(
                "ZOO_TPU_FAULTS: skipping malformed entry %r (%s)",
                entry, e)
    _arm_env_pending_locked()


_ENV_SPECS: "Dict[str, tuple]" = {}


def _arm_env_pending_locked():
    for name in list(_ENV_SPECS):
        fp = _points.get(name)
        if fp is None or fp._spec is not None:
            continue
        kind, kw = _ENV_SPECS.pop(name)
        try:
            fp._spec = _Spec(kind, seconds=kw["seconds"],
                             times=kw["times"], p=kw["p"],
                             where=kw["where"] or None)
        except ValueError:
            from analytics_zoo_tpu_torch.common.nncontext import logger
            logger.warning(
                "ZOO_TPU_FAULTS: unknown kind %r for point %s",
                kind, name)


def reset_faults():
    """Disarm everything and forget the parsed env (test isolation —
    lets a test monkeypatch ``ZOO_TPU_FAULTS`` and re-trigger the
    parse)."""
    global _env_parsed
    disarm_all()
    with _lock:
        _env_parsed = False
        _ENV_SPECS.clear()

"""Helpers of the serving examples: JSON over HTTP to a local
``InferenceServer`` and the ``/debug/slo`` summary each one prints."""

from __future__ import annotations

import json
import urllib.request


def call(port: int, path: str, payload=None, timeout: float = 120.0):
    """``POST`` the JSON ``payload`` (``GET`` when None) to the server on
    ``port`` and return the parsed reply."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def slo_baseline(port: int) -> None:
    """Tick the server's SLO engine once before the traffic: the final
    tick's windows measure from this snapshot."""
    call(port, "/debug/slo")


def print_slo(port: int) -> dict:
    """Print and return ``{objective id: state}`` from the server's
    ``GET /debug/slo`` (which ticks the engine first)."""
    status = call(port, "/debug/slo")
    states = {o["id"]: o["state"] for o in status["objectives"]}
    for o in status["objectives"]:
        print(f"slo {o['id']}: {o['state']} (value {o['value']})")
    return states

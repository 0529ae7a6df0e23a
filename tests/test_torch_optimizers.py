"""The port's optimizers against optax, the JAX package's transformations
(``analytics_zoo_tpu/ops/optimizers.py``'s ``to_optax``), on the same
seeded numpy parameters and gradients: AdamW, RMSprop, Adagrad,
Adadelta and Adamax (with a constant rate and with a schedule) over
several steps, the two clippings, the registry and its defaults, the
optax state layout a checkpoint carries, ``plateau``, and a constant
number of multi-tensor calls per step.

Tolerance: parameters and moments within 1e-6 of max(1, max|ref|) after
each step (f32; a multiply and an add fused or not, a square root
against a reciprocal square root).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu.ops import optimizers as jopt
from analytics_zoo_tpu_torch.ops import optimizers as topt

TOL = 1e-6
SHAPES = {"a": {"kernel": (5, 3), "bias": (3,)}, "b": {"kernel": (3, 2)},
          "c": {"gamma": (4,)}}


def _tree(rs, scale=1.0):
    return {k: {n: (scale * rs.randn(*s)).astype(np.float32)
                for n, s in sub.items()} for k, sub in SHAPES.items()}


def _leaves(tree):
    """The leaves in the port's order (insertion) and the reference's
    (sorted keys)."""
    port = [tree[k][n] for k in tree for n in tree[k]]
    return port, jax.tree_util.tree_leaves(tree)


def _order(tree):
    paths = [(k, n) for k in tree for n in tree[k]]
    return sorted(range(len(paths)), key=lambda i: paths[i])


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _sched(step):
    return 0.02 / (1.0 + 0.5 * step)


CASES = [
    ("AdamW", dict(lr=1e-2)),
    ("AdamW", dict(lr=_sched, weight_decay=0.05)),
    ("RMSprop", dict(lr=1e-2)),
    ("RMSprop", dict(lr=_sched, decay_rate=0.8, epsilon=1e-6)),
    ("Adagrad", dict(lr=0.1)),
    ("Adagrad", dict(lr=_sched)),
    ("Adadelta", dict()),
    ("Adadelta", dict(lr=_sched, rho=0.9)),
    ("Adamax", dict(lr=1e-2)),
    ("Adamax", dict(lr=_sched)),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_optimizer_matches_optax(name, kw):
    rs = np.random.RandomState(0)
    p0 = _tree(rs)
    tx = getattr(jopt, name)(**kw).to_optax()
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = tx.init(jparams)
    opt = getattr(topt, name)(**kw)
    leaves = [torch.from_numpy(a.copy()) for a in _leaves(p0)[0]]
    state = opt.init(leaves)
    order = _order(p0)
    for step in range(5):
        g = _tree(rs, scale=0.5 + step)
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.update(leaves, [torch.from_numpy(a) for a in _leaves(g)[0]],
                   state)
        got_tree = jax.device_get(jparams)
        want = [got_tree[k][n] for k in p0 for n in p0[k]]
        for i, (t, w) in enumerate(zip(leaves, want)):
            _close(t.numpy(), w, f"{name} step {step + 1} leaf {i}")
    # the state in optax's layout: every leaf of the reference's state
    ref = [np.asarray(a) for a in
           jax.tree_util.tree_leaves(jax.device_get(jstate))]
    got = opt.to_optax_leaves(state, order)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.dtype,
                                                           b.dtype)
        _close(a, b, f"{name} state leaf {i}")
    # and back: the same state from optax's leaves (a layout without a
    # count takes the checkpoint's step)
    back = opt.from_optax_leaves(ref, order, leaves, count=5)
    assert back["count"] == state["count"] == 5
    for key in opt._moments:
        for a, b in zip(back[key], state[key]):
            _close(a.numpy(), b.numpy(), f"{name} {key} round trip")


def test_clip_by_global_norm_matches_optax():
    rs = np.random.RandomState(1)
    for scale in (0.01, 5.0):           # below and above the norm
        g = _tree(rs, scale)
        want = jax.device_get(optax.clip_by_global_norm(1.0).update(
            g, optax.EmptyState())[0])
        got = topt.clip_by_global_norm(
            [torch.from_numpy(a) for a in _leaves(g)[0]], 1.0)
        for a, b in zip(got, [want[k][n] for k in g for n in g[k]]):
            _close(a.numpy(), b, f"scale {scale}")


def test_clip_constant_matches_jnp_clip():
    rs = np.random.RandomState(2)
    g = _tree(rs)
    got = topt.clip_constant([torch.from_numpy(a) for a in _leaves(g)[0]],
                             -0.3, 0.5)
    for a, b in zip(got, _leaves(g)[0]):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(jnp.clip(b, -0.3, 0.5)))


def test_registry_and_defaults_are_the_reference():
    assert sorted(topt._REGISTRY) == sorted(jopt._REGISTRY)
    for name, jcls in jopt._REGISTRY.items():
        t, j = topt.get(name), jcls()
        assert type(t).__name__ == type(j).__name__
        for attr in ("lr", "momentum", "nesterov", "weight_decay", "beta_1",
                     "beta_2", "epsilon", "decay_rate", "rho"):
            if hasattr(j, attr):
                assert getattr(t, attr) == getattr(j, attr), (name, attr)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get("lamb")
    with pytest.raises(NotImplementedError):
        topt.plateau(0.1)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(lr=0.1, momentum=0.9)),
    ("SGD", dict(lr=_sched)),
    ("Adam", dict(lr=_sched)),
    ("AdamW", dict()), ("RMSprop", dict(lr=_sched)), ("Adagrad", dict()),
    ("Adadelta", dict(lr=_sched)), ("Adamax", dict())])
def test_optax_layout_is_the_reference_estimators(name, kw):
    # the leaves the JAX Estimator's state holds (its multi_transform of
    # the clip and the method, the frozen leaves masked out) are the
    # layout the port writes
    tx = getattr(jopt, name)(**kw).to_optax()
    p0 = _tree(np.random.RandomState(3))
    labels = {"a": {"kernel": "train", "bias": "train"},
              "b": {"kernel": "train"}, "c": {"gamma": "freeze"}}
    full = optax.multi_transform(
        {"train": optax.chain(optax.clip_by_global_norm(1.0), tx),
         "freeze": optax.set_to_zero()}, labels)
    ref = jax.tree_util.tree_leaves(full.init(p0))
    trainable = {k: {n: v for n, v in sub.items()
                     if labels[k][n] == "train"}
                 for k, sub in p0.items() if k != "c"}
    opt = getattr(topt, name)(**kw)
    leaves = [torch.from_numpy(a) for a in _leaves(trainable)[0]]
    got = opt.to_optax_leaves(opt.init(leaves), _order(trainable))
    assert [(a.shape, a.dtype) for a in got] == \
        [(np.asarray(b).shape, np.asarray(b).dtype) for b in ref]


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("step", [
    lambda opt, ls, gs, st: opt.update(ls, gs, st),
    lambda opt, ls, gs, st: topt.clip_by_global_norm(gs, 1.0),
    lambda opt, ls, gs, st: topt.clip_constant(gs, -1.0, 1.0)],
    ids=["update", "clip_norm", "clip_constant"])
@pytest.mark.parametrize("name", ["AdamW", "RMSprop", "Adagrad", "Adadelta",
                                  "Adamax"])
def test_calls_per_step_do_not_grow_with_the_leaves(name, step):
    counts = []
    for n in (3, 60):
        opt = getattr(topt, name)()
        leaves = [torch.zeros(4) for _ in range(n)]
        state = opt.init(leaves)
        grads = [torch.ones(4) for _ in range(n)]
        with _OpCount() as mode:
            step(opt, leaves, grads, state)
        counts.append(mode.n)
    assert counts[0] == counts[1] and counts[0] < 25, counts

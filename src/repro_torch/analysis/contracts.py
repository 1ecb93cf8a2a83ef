"""Determinism-contract checks for the port's registry entries.

The registries carry declared metadata the serving stack trusts:
samplers declare ``advances_state`` (a stream cache replays indices only
for a sampler that does not advance the LFSR state), routers and batch
policies are pure functions of their arguments by contract.  This module
checks those declarations by running each entry, where
``repro.analysis.contracts`` traces it to a jaxpr:

RPA301  a sampler's declared ``advances_state`` contradicts what it does:
        run on small CPU tensors, the LFSR state it returns differs from
        the one passed in exactly when it advances.  A mislabel corrupts
        the stream cache: a stateful sampler replayed from a cache would
        fork the LFSR walk.
RPA302  two runs of an entry on the same inputs are not bitwise equal
        (a sampler, a grouper and its ``neighbor_index``, a backend), or
        the entry cannot run on the probe: host state (a Python RNG, a
        counter, the clock) leaks into its result.
RPA303  a router or policy breaks the pure-function contract on a probe:
        another pick for a permuted candidate list, another answer on
        exact replay, or its own state changed by ``decide``.  These
        probes are ``repro.analysis.contracts``'s, copied.

Entry points: :func:`check_sampler_contracts`,
:func:`check_grouper_contracts`, :func:`check_backend_contracts`,
:func:`check_router_contracts`, :func:`check_policy_contracts` and
:func:`check_registry_contracts` (all of them).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.analysis.findings import Finding, finding
from repro_torch.api import registry

_PROBE_SEED = 0


def _probe(*shape, integers: Optional[int] = None) -> torch.Tensor:
    """A small CPU tensor from a fixed seed (indices below ``integers``
    when given)."""
    gen = torch.Generator().manual_seed(_PROBE_SEED)
    if integers is not None:
        return torch.randint(integers, shape, generator=gen)
    return torch.randn(shape, generator=gen)


def _bitwise_equal(a: Any, b: Any) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    if isinstance(a, (tuple, list)) and isinstance(b, (tuple, list)):
        return (len(a) == len(b)
                and all(_bitwise_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_bitwise_equal(a[k], b[k])
                                            for k in a)
    return a == b


def _run_twice(fn: Callable[[], Any], where: str) -> tuple:
    """(first result, findings): run ``fn`` twice; RPA302 when it raises
    or when the two results differ by a bit."""
    try:
        first, second = fn(), fn()
    except Exception as e:  # noqa: BLE001 — a probe that cannot run is the finding
        return None, [finding("RPA302", where,
                              f"probe raised {type(e).__name__}: {e}")]
    if not _bitwise_equal(first, second):
        return first, [finding(
            "RPA302", where,
            "two runs on the same inputs differ: host state (a Python "
            "RNG, a counter, the clock) leaks into the result, breaking "
            "the determinism contract")]
    return first, []


def check_sampler_contracts(names: Optional[Sequence[str]] = None
                            ) -> List[Finding]:
    """RPA301/302 over registered samplers (all when ``names`` is None).
    A sampler without a declared ``advances_state`` is skipped: the
    ``stream-contract`` pass (RPA015) owns that gap."""
    from repro_torch.core import sampling
    out: List[Finding] = []
    xyz = _probe(2, 16, 3)
    state = sampling.seed_streams(_PROBE_SEED, 2)
    for name in (names if names is not None else registry.SAMPLERS.names()):
        fn = registry.SAMPLERS.get(name)
        declared = getattr(fn, "advances_state", None)
        if declared is None:
            continue
        where = f"sampler:{name}"
        result, found = _run_twice(
            lambda _fn=fn: _fn(xyz.clone(), 4, state.clone(), False), where)
        out += found
        if result is None:
            continue
        new_state = result[-1]
        advances = not (isinstance(new_state, torch.Tensor)
                        and _bitwise_equal(new_state, state))
        if bool(declared) != advances:
            did = "advances" if advances else "returns unchanged"
            out.append(finding(
                "RPA301", where,
                f"sampler {name!r} declares advances_state={bool(declared)} "
                f"but it {did} the LFSR state it is given; a mislabel here "
                f"forks the stream-cache replay from the cold LFSR walk"))
    return out


def check_grouper_contracts(names: Optional[Sequence[str]] = None
                            ) -> List[Finding]:
    """RPA302 over registered groupers: the whole entry and, where it has
    one, its ``neighbor_index`` half."""
    out: List[Finding] = []
    xyz, feats = _probe(2, 16, 3), _probe(2, 16, 8)
    idx = _probe(2, 4, integers=16)
    new_xyz = torch.gather(xyz, 1, idx[..., None].expand(2, 4, 3))
    for name in (names if names is not None else registry.GROUPERS.names()):
        fn = registry.GROUPERS.get(name)
        where = f"grouper:{name}"
        out += _run_twice(
            lambda _fn=fn: _fn(xyz, feats, idx, 4, None, "norm", True),
            where)[1]
        nbr = getattr(fn, "neighbor_index", None)
        if nbr is not None:
            out += _run_twice(lambda _fn=nbr: _fn(new_xyz, xyz, 4),
                              f"{where}.neighbor_index")[1]
    return out


def check_backend_contracts(names: Optional[Sequence[str]] = None
                            ) -> List[Finding]:
    """RPA302 over registered backends (a frozen fp32 layer)."""
    out: List[Finding] = []
    params = {"w": _probe(8, 16), "b": _probe(16)}
    x = _probe(4, 8)
    for name in (names if names is not None else registry.BACKENDS.names()):
        fn = registry.BACKENDS.get(name)
        out += _run_twice(lambda _fn=fn: _fn(params, x, None, True),
                          f"backend:{name}")[1]
    return out


def _probe_views():
    from repro_torch.serve.router import ReplicaView
    return [ReplicaView(replica_id=i, tier="tier", depth=d, pending=p,
                        max_batch=8)
            for i, (d, p) in enumerate([(0, 5), (2, 2), (1, 7)])]


def check_router_contracts(names: Optional[Sequence[str]] = None
                           ) -> List[Finding]:
    """RPA303 over registered routers: the same pick under candidate-order
    permutation, on exact replay, and with equal (fresh) state."""
    from repro_torch.serve.router import ROUTERS
    out: List[Finding] = []
    views = _probe_views()
    for name in (names if names is not None else ROUTERS.names()):
        fn = ROUTERS.get(name)
        where = f"router:{name}"
        try:
            pick = fn("tenant-a", views, {})
            replay = fn("tenant-a", views, {})
            permuted = fn("tenant-a", list(reversed(views)), {})
        except Exception as e:  # noqa: BLE001 — a crashing probe is the finding
            out.append(finding("RPA303", where,
                               f"router probe raised {type(e).__name__}: "
                               f"{e}"))
            continue
        if pick != replay:
            out.append(finding(
                "RPA303", where,
                f"router {name!r} returned different picks ({pick} vs "
                f"{replay}) for identical (candidates, state): it is not a "
                f"pure function of its arguments"))
        if pick != permuted:
            out.append(finding(
                "RPA303", where,
                f"router {name!r} pick depends on candidate *order* "
                f"({pick} vs {permuted} under permutation): the fleet "
                f"snapshots views in no guaranteed order"))
    return out


def check_policy_contracts(names: Optional[Sequence[str]] = None
                           ) -> List[Finding]:
    """RPA303 over registered batch policies: ``decide`` must be a pure
    function of (depth, oldest_wait_ms, max_batch) and the constructor
    state: the same answers on replay, no state changed by deciding."""
    from repro_torch.serve.policy import POLICIES, make_policy
    out: List[Finding] = []
    probes = [(0, 0.0), (3, 10.0), (8, 0.0), (5, 60.0), (12, 120.0)]
    for name in (names if names is not None else POLICIES.names()):
        where = f"policy:{name}"
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                policy = make_policy(name, slo_ms=50.0, dispatch_ms=5.0)
            before = repr(vars(policy))
            first = [policy.decide(d, w, 8) for d, w in probes]
            second = [policy.decide(d, w, 8) for d, w in probes]
            after = repr(vars(policy))
        except Exception as e:  # noqa: BLE001 — a crashing probe is the finding
            out.append(finding("RPA303", where,
                               f"policy probe raised {type(e).__name__}: "
                               f"{e}"))
            continue
        if first != second:
            out.append(finding(
                "RPA303", where,
                f"policy {name!r} gave different decide() answers on exact "
                f"replay ({first} vs {second}): not a pure function of its "
                f"arguments"))
        if before != after:
            out.append(finding(
                "RPA303", where,
                f"policy {name!r} mutated its own state inside decide() "
                f"({before} -> {after}): calibration must go through "
                f"calibrate(), never a decide side effect"))
    return out


def check_registry_contracts() -> List[Finding]:
    """Every contract check over every registered entry: the CLI's
    contracts stage."""
    return (check_sampler_contracts() + check_grouper_contracts()
            + check_backend_contracts() + check_router_contracts()
            + check_policy_contracts())

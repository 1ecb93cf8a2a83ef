"""The port's static analyzer (``repro_torch.analysis``) held against ``repro.analysis``.

The same specs, built in both packages from the same helpers and field
overrides (backend keys mapped: the port's ``cuda`` is JAX's
``pallas_interpret``), go through both analyzers; the findings must agree
as (code, severity, op) triples, scope by scope.  The messages are the
port's own (each names the spec field to change) and are not compared.

* findings: the code table is JAX's, ``render``/``str`` have JAX's
  format, ``enforce`` warns and raises as JAX's does;
* spec passes: the shipped variants, the ladder, the stream and seg
  variants, README.md's fleet and ``tests/test_analysis.py``'s planted
  bad specs, RPA104's wide stage included;
* the verdict predicts lowering: over a deterministic grid, "no error
  finding" holds exactly when the port's ``plan.lower`` succeeds (the
  CLI's RPA298), and JAX's analyzer agrees on every point;
* contracts: a mislabelled sampler, an honest stateless one, a sampler
  whose two runs differ, a router that depends on order and a policy
  that mutates itself;
* the CLI in a subprocess.
"""
import itertools
import json
import os
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch

from repro.analysis import AnalysisWarning as JaxAnalysisWarning
from repro.analysis import CODES as JAX_CODES
from repro.analysis import contracts as JC
from repro.analysis import enforce as jax_enforce
from repro.analysis import finding as jax_finding
from repro.analysis import passes as JP
from repro.api import registry as JR
from repro.api import spec as JS
from repro_torch.analysis import (CODES, AnalysisWarning, dedupe, enforce,
                                  error_codes, finding, has_errors)
from repro_torch.analysis import contracts as C
from repro_torch.analysis import passes as P
from repro_torch.analysis.__main__ import readme_fleet_spec
from repro_torch.api import plan as tplan
from repro_torch.api import registry as R
from repro_torch.api import spec as TS
from repro_torch.api.spec import UnknownKeyError

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# Backend keys: the port's hand kernels against JAX's Pallas kernels, run
# here in interpret mode.
TO_JAX = {"cuda": "pallas_interpret"}


def _jax_over(over):
    out = {}
    for k, v in over.items():
        if k == "backend":
            v = TO_JAX.get(v, v)
        elif k == "stage_backend" and v is not None:
            v = tuple(TO_JAX.get(b, b) for b in v)
        out[k] = v
    return out


def pair(helper: str, *args, serving=False, **over):
    """The same spec in both packages: ``helper(*args)``, ``.serving()``
    when asked, then ``.replace(**over)``."""
    t = getattr(TS, helper)(*args)
    j = getattr(JS, helper)(*args)
    if serving:
        t, j = t.serving(), j.serving()
    return t.replace(**over), j.replace(**_jax_over(over))


def tiny_pair(**over):
    """``tests/test_analysis.py``'s tiny spec (overrides after
    ``.serving()``, so a test can undo per_sample_norm)."""
    base = dict(n_points=128, embed_dim=16, k_neighbors=8,
                precision="fp32", backend="ref")
    base.update(over)
    return pair("lite_spec", 8, serving=True, **base)


def triples(found):
    return [(f.code, f.severity, f.op) for f in found]


def jax_triples(found):
    return [(f.code, f.severity,
             f.op.replace("pallas_interpret", "cuda")) for f in found]


def assert_same_findings(t_spec, j_spec, scopes=None):
    got = P.analyze_spec(t_spec, scopes=scopes)
    want = JP.analyze_spec(j_spec, scopes=scopes)
    assert triples(got) == jax_triples(want), (t_spec.name, scopes)
    return got


# ------------------------------------------------------------------ #
# findings primitives                                                #
# ------------------------------------------------------------------ #

class TestFindings:
    def test_code_table_is_jax(self):
        assert CODES == JAX_CODES

    @pytest.mark.parametrize("code", ["RPA001", "RPA011", "RPA020",
                                      "RPA104", "RPA301", "RPA900"])
    def test_render_and_str_match_jax(self, code):
        got = finding(code, "spec.x", "a message")
        want = jax_finding(code, "spec.x", "a message")
        assert got.severity == want.severity
        assert got.render() == want.render() == f"{code}: a message"
        assert str(got) == str(want)

    def test_unknown_code_rejected(self):
        with pytest.raises(ValueError, match="RPA999"):
            finding("RPA999", "op", "m")

    def test_enforce_warns_then_raises_as_jax(self):
        def run(make, enf, category):
            fs = [make("RPA101", "a", "soft"), make("RPA011", "b", "hard"),
                  make("RPA001", "c", "key", exc_type=KeyError)]
            with pytest.warns(category) as rec:
                with pytest.raises(ValueError) as exc:
                    enf(fs)
            return [str(w.message) for w in rec], str(exc.value)

        assert (run(finding, enforce, AnalysisWarning)
                == run(jax_finding, jax_enforce, JaxAnalysisWarning))
        assert issubclass(AnalysisWarning, UserWarning)
        with pytest.raises(KeyError, match="RPA001"):
            enforce([finding("RPA001", "c", "key", exc_type=KeyError)])
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            enforce([finding("RPA900", "mod", "info only")])

    def test_helpers(self):
        a, b = finding("RPA101", "x", "m1"), finding("RPA101", "x", "m2")
        c = finding("RPA011", "y", "m3")
        assert dedupe([a, b, c]) == [a, c]
        assert error_codes([c, finding("RPA010", "z", "m"), a]) == (
            "RPA010", "RPA011")
        assert has_errors([a, c]) and not has_errors([a])


# ------------------------------------------------------------------ #
# spec passes against JAX's                                          #
# ------------------------------------------------------------------ #

def _variants():
    out = [pair(h, 40) for h in ("elite_spec", "m2_spec", "lite_spec")]
    out += [pair(h, 40, serving=True, backend="cuda")
            for h in ("elite_spec", "m2_spec", "lite_spec")]
    out.append(pair("elite_spec", 40, serving=True, backend="cuda",
                    fused_group="grouped_transfer"))
    out.append(pair("lite_spec", name="pointmlp-lite-stream", stream=True,
                    stream_drift_threshold=0.05))
    out.append(pair("m2_spec", name="pointmlp-m2-seg", head="seg"))
    out += list(zip(TS.compression_ladder_specs(),
                    JS.compression_ladder_specs()))
    return out


@pytest.mark.parametrize("scope", [None, *P.SCOPES])
def test_shipped_variants_match_jax(scope):
    """The variants the CLI sweeps: clean in both packages, per scope."""
    for t, j in _variants():
        assert assert_same_findings(t, j, [scope] if scope else None) == []


PLANTED = [
    (dict(sampler="voxel"), "RPA001"),
    (dict(grouper="octree"), "RPA002"),
    (dict(backend="tpu-v9"), "RPA003"),
    (dict(stage_backend=("ref", "ref", "tpu-v9", "ref")), "RPA003"),
    (dict(fused_group="mega_fuse"), "RPA004"),
    (dict(policy="nope"), "RPA005"),
    (dict(grouper="ball", fused_group="grouped_transfer"), "RPA010"),
    (dict(precision="int8", fused_group="grouped_transfer"), "RPA011"),
    (dict(fuse=False, fused_group="grouped_transfer"), "RPA012"),
    (dict(stream=True, stream_drift_threshold=0.05,
          fused_group="grouped_transfer"), "RPA013"),
    (dict(data_shards=2, per_sample_norm=False), "RPA020"),
    (dict(precision="int8", stage_backend=("ref", "cuda", "ref", "ref")),
     None),
]


@pytest.mark.parametrize("over,code", PLANTED)
def test_planted_specs_match_jax(over, code):
    """``tests/test_analysis.py``'s known-bad shapes give JAX's findings,
    scope by scope, and their code."""
    t, j = tiny_pair(**over)
    for scope in (None, *P.SCOPES):
        assert_same_findings(t, j, [scope] if scope else None)
    codes = [f.code for f in P.analyze_spec(t)]
    assert (code in codes) if code else codes == []


def test_wide_stage_is_rpa104_as_in_jax():
    t, j = pair("lite_spec", 8, serving=True, stage_expansion=(1, 1, 1, 64))
    found = assert_same_findings(t, j, ["perf"])
    assert [(f.code, f.op, f.severity) for f in found] == [
        ("RPA104", "plan.stage4", "warning")]
    assert "x off" in found[0].message
    assert (set(P.stage_intensities(t))
            == {"stage1", "stage2", "stage3", "stage4"})
    # depth scales FLOPs and bytes together: no anomaly
    t, j = tiny_pair(pre_blocks=(1, 1, 2, 2))
    assert assert_same_findings(t, j, ["perf"]) == []


def test_stream_registry_gaps_match_jax():
    def bare_grouper(xyz, feats, idx, k, affine, mode, per_sample):
        raise AssertionError("never called")

    def bare_sampler(xyz, n, state, shared):
        raise AssertionError("never called")

    for reg in (R, JR):
        reg.GROUPERS.register("_rpa_bare_grouper")(bare_grouper)
        reg.SAMPLERS.register("_rpa_bare_sampler")(bare_sampler)
    try:
        t, j = tiny_pair(stream=True, stream_drift_threshold=0.05,
                         grouper="_rpa_bare_grouper",
                         sampler="_rpa_bare_sampler")
        found = assert_same_findings(t, j, ["lowering"])
        assert {"RPA014", "RPA015"} <= {f.code for f in found}
    finally:
        for reg in (R, JR):
            reg.GROUPERS.unregister("_rpa_bare_grouper")
            reg.SAMPLERS.unregister("_rpa_bare_sampler")


def test_fleet_specs_match_jax():
    """README.md's fleet is clean in both; a fleet with an unknown router
    and a bad pool pipeline gives JAX's prefixed findings."""
    t_fleet = readme_fleet_spec()
    j_fleet = JS.FleetSpec(
        pipelines=(JS.lite_spec(40).serving(), JS.elite_spec(40).serving()),
        tenants=(JS.TenantSpec("lidar", "pointmlp-lite", slo_ms=20.0,
                               max_inflight=8),
                 JS.TenantSpec("analytics", "pointmlp-elite", slo_ms=0.0)),
        replicas=2, router="least-loaded", max_batch=8)
    assert P.analyze_fleet_spec(t_fleet) == []
    assert JP.analyze_fleet_spec(j_fleet) == []

    (ta, ja), (tb, jb) = tiny_pair(name="a"), tiny_pair(name="b",
                                                        grouper="octree")
    got = P.analyze_fleet_spec(TS.FleetSpec(
        pipelines=(ta, tb), tenants=(TS.TenantSpec(name="t", tier="a"),),
        router="no-such-router"))
    want = JP.analyze_fleet_spec(JS.FleetSpec(
        pipelines=(ja, jb), tenants=(JS.TenantSpec(name="t", tier="a"),),
        router="no-such-router"))
    assert triples(got) == jax_triples(want)
    assert {"RPA002", "RPA006"} <= {f.code for f in got}
    assert got[0].op.startswith("pipeline[b].")


def test_skip_list_matches_jax_in_size():
    found = P.skip_list_findings()
    assert len(found) == len(JP.skip_list_findings()) == 10
    assert all(f.code == "RPA900" and f.severity == "info" for f in found)
    assert P.pass_names() == JP.pass_names()


# ------------------------------------------------------------------ #
# the passes are the port's spec rules                               #
# ------------------------------------------------------------------ #

class TestEnforcement:
    def test_validate_raises_coded_errors(self):
        t, _ = tiny_pair(sampler="voxel")
        with pytest.raises(UnknownKeyError, match="RPA001.*set sampler"):
            t.validate()
        t, _ = tiny_pair(grouper="ball", fused_group="grouped_transfer")
        with pytest.raises(ValueError, match="RPA010"):
            t.validate()

    def test_unported_values_refused_before_the_passes(self):
        """``data_shards=2`` without per-sample norm (the sharded dispatch
        is ported): RPA020's ``ValueError`` at validate, as JAX's, and at
        build, while ``plan.lower`` (the lowering scope) takes it, as
        JAX's does; RPA020 is the one finding."""
        t, j = tiny_pair(data_shards=2, per_sample_norm=False)
        rule = "RPA020: data_shards > 1 requires per-sample normalization"
        with pytest.raises(ValueError, match=rule):
            t.validate()
        with pytest.raises(ValueError, match=rule):
            j.validate()
        assert tplan.lower(t, t.to_model_config()).ops
        from repro.api import plan as jplan
        assert jplan.lower(j, j.to_model_config()).ops
        from repro_torch.api.build import build
        with pytest.raises(ValueError, match="RPA020"):
            build(t, {}, device="cpu")
        assert [f.code for f in P.analyze_spec(t)] == ["RPA020"]

    def test_lower_enforces_the_lowering_scope_only(self):
        t, _ = tiny_pair(policy="nope")
        assert tplan.lower(t, t.to_model_config()).ops
        with pytest.raises(UnknownKeyError, match="RPA005"):
            t.validate()
        t, _ = tiny_pair(precision="int8", fused_group="grouped_transfer")
        with pytest.raises(ValueError, match="RPA011.*stage_precision"):
            tplan.lower(t, t.to_model_config())

    def test_spec_module_holds_no_pass(self):
        for name in ("_known_key", "_check_fused", "_check_stream"):
            assert not hasattr(TS, name), name


# ------------------------------------------------------------------ #
# the verdict predicts lowering                                      #
# ------------------------------------------------------------------ #

GRID = dict(
    precision=["fp32", "int8"],
    grouper=["knn", "ball"],
    fused_group=["none", "grouped_transfer"],
    fuse=[True, False],
    stage_backend=[None, ("ref", "ref", "cuda", "ref")],
    stream=[False, True],
)


def test_verdict_predicts_lowering():
    """For every grid point, the port's "no error finding" holds exactly
    when ``plan.lower`` succeeds, and JAX's analyzer finds the same."""
    keys = sorted(GRID)
    n_err = n_ok = 0
    for vals in itertools.product(*(GRID[k] for k in keys)):
        over = dict(zip(keys, vals))
        over["stream_drift_threshold"] = 0.05 if over["stream"] else 0.0
        t, j = tiny_pair(**over)
        found = assert_same_findings(t, j)
        errs = [f for f in found if f.severity == "error"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", AnalysisWarning)
            if errs:
                n_err += 1
                with pytest.raises((ValueError, KeyError)):
                    tplan.lower(t, t.to_model_config())
            else:
                n_ok += 1
                assert tplan.lower(t, t.to_model_config()).ops
    assert n_err and n_ok


# ------------------------------------------------------------------ #
# determinism contracts                                              #
# ------------------------------------------------------------------ #

class TestContracts:
    def test_builtin_registries_clean(self):
        assert C.check_registry_contracts() == []

    @pytest.mark.parametrize("case", ["mislabelled", "honest", "noisy"])
    def test_sampler_cases(self, case):
        calls = []

        def mislabelled(xyz, n, state, shared):
            return torch.arange(n).expand(xyz.shape[0], n), state + 1

        def honest(xyz, n, state, shared):
            return torch.arange(n).expand(xyz.shape[0], n), state

        def noisy(xyz, n, state, shared):
            calls.append(1)
            return torch.full((xyz.shape[0], n), len(calls)), state

        fn = {"mislabelled": mislabelled, "honest": honest,
              "noisy": noisy}[case]
        fn.advances_state = False
        R.register_sampler("_rpa_probe")(fn)
        try:
            found = C.check_sampler_contracts(names=["_rpa_probe"])
        finally:
            R.SAMPLERS.unregister("_rpa_probe")
        want = {"mislabelled": ["RPA301"], "honest": [],
                "noisy": ["RPA302"]}[case]
        assert [f.code for f in found] == want
        if case == "mislabelled":
            assert "advances" in found[0].message

    def test_mislabelled_sampler_as_jax(self):
        def sneaky(xyz, n, state, shared):
            return xyz[:, :n, :], state + 1
        sneaky.advances_state = False
        R.register_sampler("_rpa_sneaky")(sneaky)
        JR.SAMPLERS.register("_rpa_sneaky")(sneaky)
        try:
            got = C.check_sampler_contracts(names=["_rpa_sneaky"])
            want = JC.check_sampler_contracts(names=["_rpa_sneaky"])
        finally:
            R.SAMPLERS.unregister("_rpa_sneaky")
            JR.SAMPLERS.unregister("_rpa_sneaky")
        assert triples(got) == triples(want) == [
            ("RPA301", "error", "sampler:_rpa_sneaky")]

    def test_order_dependent_router_caught(self):
        from repro_torch.serve.router import ROUTERS, register_router

        @register_router("_rpa_first")
        def first(tenant, candidates, state):
            return candidates[0].replica_id
        try:
            found = C.check_router_contracts(names=["_rpa_first"])
        finally:
            ROUTERS.unregister("_rpa_first")
        assert [f.code for f in found] == ["RPA303"]
        assert "order" in found[0].message

    def test_self_mutating_policy_caught(self):
        from repro_torch.serve.policy import (POLICIES, BatchPolicy,
                                              register_policy)

        @register_policy("_rpa_countdown")
        class Countdown(BatchPolicy):
            def __init__(self, slo_ms=0.0, dispatch_ms=0.0):
                super().__init__(slo_ms, dispatch_ms)
                self.calls = 0

            def decide(self, depth, oldest_wait_ms, max_batch):
                self.calls += 1
                return min(depth, max_batch)
        try:
            found = C.check_policy_contracts(names=["_rpa_countdown"])
        finally:
            POLICIES.unregister("_rpa_countdown")
        assert {f.code for f in found} == {"RPA303"}


# ------------------------------------------------------------------ #
# CLI                                                                #
# ------------------------------------------------------------------ #

def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], env=env, capture_output=True, text=True,
                          timeout=120)


def test_cli_all_variants_clean_as_jax(capsys):
    out = _cli("--all-variants", "-q")
    assert out.returncode == 0, out.stdout + out.stderr
    summary = out.stdout.strip().splitlines()[-1]
    from repro.analysis.__main__ import main as jax_main
    assert jax_main(["--all-variants", "--no-trace", "-q"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == summary
    assert summary == "SUMMARY: 10 finding(s), 0 error(s) [codes: none]"


def test_cli_fused_int8_spec_exits_1():
    out = _cli("--spec-json", json.dumps({"precision": "int8",
                                          "fused_group": "grouped_transfer"}),
               "--no-contracts")
    assert out.returncode == 1
    assert "RPA011" in out.stdout and "[codes: RPA011]" in out.stdout

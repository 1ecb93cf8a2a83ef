"""The port's cost model and tuner (``repro_torch.roofline``, ``repro_torch.tune``) held against JAX's.

* ``StagePlan.cost_breakdown``: rows (op, flops, w_bytes, act_bytes)
  exactly ``repro.api.plan``'s for Lite, M-2, Elite fused and unfused
  (and under the "center" affine mode) and the seg head; their FLOPs sum
  to ``pointmlp_flops``.
* ``estimate_plan``: every row, and the total, bit for bit JAX's under
  ``CPU_HOST`` and a test-local model, with the port's ``cuda`` backend
  against JAX's ``pallas_interpret`` (the tile-waste term reads the same
  tiles); the precision ladder ranks under ``H100_SXM`` too.
* ``enumerate_plan_space``: JAX's labels in JAX's order (backend names
  mapped), and JAX's fingerprints where no kernel backend is named.
* ``frontier`` and ``artifact``: copies of ``tests/test_tune.py``'s cases.
* ``tune(device="cpu")`` at 128 points: JAX's ``validate_artifact``
  accepts it, the anchor is on the frontier, the estimates are JAX's
  and the measured set is the anchor plus JAX's top-2 estimates, and
  ``scripts/bench_diff.py`` finds no regression against itself.

JAX's ``tune()`` (which compiles engines) is not run; JAX lowers plans
only, once per module.
"""
import importlib.util
import json
import pathlib
import random

import pytest
import torch

from repro import roofline as jroof
from repro.api import plan as jplan
from repro.api import spec as JS
from repro.models import pointmlp as JPM
from repro.tune import artifact as jart
from repro_torch import roofline as troof
from repro_torch.api import plan as tplan
from repro_torch.api import spec as TS
from repro_torch.api.build import build
from repro_torch.models import pointmlp as TPM
from repro_torch.tune import (ANCHOR_NAME, ArtifactError, anchor_spec,
                              new_artifact, new_row, pareto_frontier,
                              quick_space, read_artifact, tune,
                              validate_artifact, write_artifact)

_ROOT = pathlib.Path(__file__).resolve().parents[1]
TO_JAX = {"cuda": "pallas_interpret"}


def pair(helper, *args, serving=False, **over):
    """The same spec in both packages (backend keys mapped)."""
    t = getattr(TS, helper)(*args)
    j = getattr(JS, helper)(*args)
    if serving:
        t, j = t.serving(), j.serving()
    jover = dict(over)
    if "backend" in jover:
        jover["backend"] = TO_JAX.get(jover["backend"], jover["backend"])
    if jover.get("stage_backend"):
        jover["stage_backend"] = tuple(TO_JAX.get(b, b)
                                       for b in jover["stage_backend"])
    return t.replace(**over), j.replace(**jover)


def lowered(t, j):
    t_cfg, j_cfg = t.to_model_config(), j.to_model_config()
    return (tplan.lower(t, t_cfg), t_cfg), (jplan.lower(j, j_cfg), j_cfg)


BREAKDOWN_SPECS = {
    "lite": lambda: pair("lite_spec", 40, serving=True),
    "lite-cuda": lambda: pair("lite_spec", 40, serving=True,
                              backend="cuda"),
    "m2": lambda: pair("m2_spec", 40, serving=True),
    "elite": lambda: pair("elite_spec", 40, serving=True),
    "elite-fused": lambda: pair("elite_spec", 40, serving=True,
                                fused_group="grouped_transfer"),
    "elite-fused-center": lambda: pair("elite_spec", 40, serving=True,
                                       fused_group="grouped_transfer",
                                       affine_mode="center"),
    "m2-seg": lambda: pair("m2_spec", 50, serving=True, head="seg"),
    "lite-seg-cuda": lambda: pair("lite_spec", 50, serving=True,
                                  head="seg", backend="cuda"),
    "mixed-cuda": lambda: pair(
        "lite_spec", 40, serving=True,
        stage_precision=("int8", "int8", "fp32", "fp32"),
        stage_backend=("cuda", "ref", "cuda", "cuda")),
}


@pytest.fixture(scope="module")
def plans():
    """Every BREAKDOWN_SPECS pair lowered in both packages, once."""
    return {name: lowered(*make()) for name, make in BREAKDOWN_SPECS.items()}


@pytest.mark.parametrize("name", sorted(BREAKDOWN_SPECS))
def test_cost_breakdown_rows_are_jax(plans, name):
    (tp, t_cfg), (jp, j_cfg) = plans[name]
    got = tp.cost_breakdown(t_cfg)
    assert got == jp.cost_breakdown(j_cfg)
    assert sum(r["flops"] for r in got) == TPM.pointmlp_flops(t_cfg)
    assert TPM.pointmlp_flops(t_cfg) == JPM.pointmlp_flops(j_cfg)
    assert tp.tuning == TS.DEFAULT_TUNING


def test_frozen_pipeline_cost_breakdown():
    spec = TS.m2_spec(8, n_points=128, embed_dim=16, k_neighbors=8,
                      fused_group="grouped_transfer").serving()
    cfg = spec.to_model_config()
    pipe = build(spec, TPM.pointmlp_init(cfg, torch.Generator()
                                         .manual_seed(0)), device="cpu")
    assert pipe.cost_breakdown() == pipe.plan.cost_breakdown(
        pipe.model_config)
    assert pipe.cost_breakdown()[1]["act_bytes"] == 4 * 64 * 8 * 16


HW = {
    "cpu_host": (troof.CPU_HOST, jroof.CPU_HOST),
    "test_local": (troof.HardwareModel("t", 1.5e12, 6e12, 7e11, 1e-5),
                   jroof.HardwareModel("t", 1.5e12, 6e12, 7e11, 1e-5)),
}


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("name", sorted(BREAKDOWN_SPECS))
def test_estimate_rows_are_jax(plans, name, hw):
    (tp, t_cfg), (jp, j_cfg) = plans[name]
    t_hw, j_hw = HW[hw]
    got = troof.estimate_plan(tp, t_cfg, t_hw)
    want = jroof.estimate_plan(jp, j_cfg, j_hw)
    assert got.to_rows() == want.to_rows()
    assert (got.total_s, got.sps, got.bottleneck) == (
        want.total_s, want.sps, want.bottleneck)


def test_tile_waste_reads_the_plan_tuning():
    """On ``cuda`` stages the compute term pays JAX's tile padding: more
    than on ``ref``, where it is 1."""
    spec = TS.lite_spec(40, precision="fp32").serving()
    ref = troof.estimate_plan(*lowered_one(spec), troof.CPU_HOST)
    cuda = troof.estimate_plan(*lowered_one(spec.replace(
        stage_backend=("cuda",) * 4)), troof.CPU_HOST)
    assert cuda.t_compute > ref.t_compute and cuda.t_memory == ref.t_memory
    assert troof._ceil_waste(96, 128) == 128 / 96


def lowered_one(spec):
    cfg = spec.to_model_config()
    return tplan.lower(spec, cfg), cfg


@pytest.mark.parametrize("hw", [troof.CPU_HOST, troof.H100_SXM])
def test_precision_ladder_ranks(hw):
    """all-int8 <= mixed <= all-fp32 on estimated time (int8 buys a
    higher peak and smaller weights) under each model."""
    base = TS.lite_spec(8, n_points=64, embed_dim=16, k_neighbors=4,
                        precision="fp32")
    t = [troof.estimate_plan(*lowered_one(base.replace(stage_precision=p)),
                             hw).total_s
         for p in (("int8",) * 4, ("int8", "int8", "fp32", "fp32"),
                   ("fp32",) * 4)]
    assert t[0] <= t[1] <= t[2] and t[0] < t[2]


# ------------------------------------------------------- plan space ----

def test_plan_space_labels_and_fingerprints_are_jax():
    t_base, j_base = pair("lite_spec", 40, serving=True)
    kw = dict(fused_groups=("none", "grouped_transfer", "no-such-kernel"))
    t_space = tplan.enumerate_plan_space(
        t_base, stage_backends=(("ref",) * 4, ("cuda",) * 4), **kw)
    j_space = jplan.enumerate_plan_space(
        j_base, stage_backends=(("ref",) * 4, ("pallas_interpret",) * 4),
        **kw)
    assert ([tplan.spec_label(s).replace("be=cuda", "be=pallas_interpret")
             for s in t_space] == [jplan.spec_label(s) for s in j_space])
    assert len(t_space) == 10
    n_ref = 0
    for t, j in zip(t_space, j_space):
        if set(t.stage_backend) == {"ref"}:
            n_ref += 1
            assert tplan.spec_fingerprint(t) == jplan.spec_fingerprint(j)
        tplan.lower(t, t.to_model_config())      # every point lowers
    assert n_ref == 5
    assert tplan.spec_fingerprint(anchor_spec(t_base)) == \
        jplan.spec_fingerprint(j_base.replace(
            precision="fp32", stage_precision=None, stage_backend=None,
            backend="ref", fused_group="none", data_shards=1))


def test_quick_space_is_jax_first_tiles_on_one_device():
    base = TS.lite_spec(40).serving()
    space = quick_space(base)
    assert all(s.kernel_tuning == TS.DEFAULT_TUNING and s.data_shards == 1
               for s in space)
    assert {s.stage_backend for s in space} == {("ref",) * 4,
                                                ("cuda",) * 4}
    assert "/kt=" not in tplan.spec_label(space[0])
    tiles = TS.KernelTuning(fused_linear=(64, 64, 64))
    assert tplan.spec_label(base.replace(kernel_tuning=tiles)) == \
        jplan.spec_label(JS.lite_spec(40).serving().replace(
            kernel_tuning=JS.KernelTuning(fused_linear=(64, 64, 64))))


# ---------------------------------------------------------- frontier ----

def _pt(name, err, sps):
    return new_row(name, measured_sps=sps, err_vs_fp32=err)


class TestFrontier:
    ROWS = [_pt("a", 0.0, 100.0), _pt("b", 0.01, 150.0),
            _pt("c", 0.02, 120.0), _pt("d", 0.03, 200.0),
            _pt("e", 0.01, 150.0)]

    def test_selection(self):
        assert [r["name"] for r in pareto_frontier(self.ROWS)] == \
            ["a", "b", "e", "d"]

    def test_deterministic_under_shuffle(self):
        baseline = pareto_frontier(self.ROWS)
        for seed in range(5):
            shuffled = list(self.ROWS)
            random.Random(seed).shuffle(shuffled)
            assert pareto_frontier(shuffled) == baseline

    def test_unmeasured_rows_excluded(self):
        rows = self.ROWS + [new_row("est-only", estimated_sps=1e6)]
        assert all(r["name"] != "est-only" for r in pareto_frontier(rows))


# ---------------------------------------------------------- artifact ----

class TestArtifact:
    def _doc(self):
        return new_artifact(
            [new_row("fp32-ref", measured_sps=100.0, err_vs_fp32=0.0,
                     anchor=True, frontier=True,
                     stages=[{"op": "embed", "flops": 10}]),
             new_row("mixed", measured_sps=140.0, err_vs_fp32=0.01,
                     estimated_sps=150.0, fingerprint="abc123def456")],
            rev="deadbee")

    def test_roundtrip_and_jax_reads_it(self, tmp_path):
        doc = self._doc()
        path = write_artifact(tmp_path / "BENCH_deadbee.json", doc)
        assert read_artifact(path) == doc == jart.read_artifact(path)
        assert json.loads(path.read_text())["schema"] == "repro.bench/v1"

    def test_old_schema_rejected(self, tmp_path):
        doc = self._doc()
        doc["schema"] = "repro.bench/v0"
        with pytest.raises(ArtifactError, match="repro.bench/v1"):
            validate_artifact(doc)
        (tmp_path / "old.json").write_text(json.dumps(doc))
        with pytest.raises(ArtifactError, match="regenerate"):
            read_artifact(tmp_path / "old.json")

    @pytest.mark.parametrize("mutate,msg", [
        (lambda d: d.pop("rows"), "rows"),
        (lambda d: d["rows"].append({"no_name": 1}), "name"),
        (lambda d: d["rows"].append({"name": "fp32-ref"}), "duplicate"),
        (lambda d: d["rows"][0].update(measured_sps=float("nan")),
         "finite"),
        (lambda d: d["rows"][0].update(frontier="yes"), "bool"),
    ])
    def test_malformed_rejected(self, mutate, msg):
        doc = self._doc()
        mutate(doc)
        with pytest.raises(ArtifactError, match=msg):
            validate_artifact(doc)

    def test_unreadable_file(self, tmp_path):
        p = tmp_path / "garbage.json"
        p.write_text("{not json")
        with pytest.raises(ArtifactError, match="garbage.json"):
            read_artifact(p)


# ------------------------------------------------------- end to end -----

TUNE_BASE = dict(n_points=128)


@pytest.fixture(scope="module")
def doc():
    return tune(TS.lite_spec(40, **TUNE_BASE), max_batch=4, n_requests=8,
                top_k=2, seed=0, rev="testrev", device="cpu")


@pytest.fixture(scope="module")
def jax_estimates():
    """JAX's CPU_HOST estimate of each twin of the port's quick space,
    keyed by the port's label."""
    t_base, j_base = pair("lite_spec", 40, serving=True, **TUNE_BASE)
    out = {}
    for t in [anchor_spec(t_base)] + quick_space(t_base):
        over = {k: getattr(t, k) for k in ("stage_precision",
                                           "stage_backend", "precision",
                                           "backend", "fused_group",
                                           "kernel_tuning")}
        over["stage_backend"] = tuple(TO_JAX.get(b, b)
                                      for b in over["stage_backend"] or
                                      (t.backend,) * 4)
        if over["kernel_tuning"] is not None:
            over["kernel_tuning"] = JS.KernelTuning()
        j = j_base.replace(**over)
        cfg = j.to_model_config()
        est = jroof.estimate_plan(jplan.lower(j, cfg), cfg, jroof.CPU_HOST)
        label = ANCHOR_NAME if t.kernel_tuning is None else \
            tplan.spec_label(t)
        out[label] = est
    return out


def test_tune_artifact_passes_jax_validation(doc):
    assert jart.validate_artifact(doc) is doc
    assert doc["rev"] == "testrev" and doc["source"] == "repro_torch.tune"
    assert doc["hw"]["name"] == "cpu_host"
    anchor = doc["rows"][0]
    assert anchor["anchor"] and anchor["name"] == ANCHOR_NAME
    assert anchor["measured_sps"] is not None and anchor["frontier"]
    assert anchor["err_vs_fp32"] == 0.0 and anchor["stages"]
    names = [r["name"] for r in doc["rows"]]
    assert len(set(names)) == len(names) == 11


def test_tune_follows_jax_estimates(doc, jax_estimates):
    """Every estimate is JAX's, and the measured set is the anchor plus
    the two candidates JAX estimates fastest."""
    rows = {r["name"]: r for r in doc["rows"]}
    assert set(rows) == set(jax_estimates)
    for name, est in jax_estimates.items():
        assert rows[name]["estimated_sps"] == est.sps, name
    top2 = sorted((n for n in jax_estimates if n != ANCHOR_NAME),
                  key=lambda n: jax_estimates[n].total_s)[:2]
    measured = {n for n, r in rows.items() if r["measured_sps"] is not None}
    assert measured == {ANCHOR_NAME, *top2}
    assert all(rows[n]["err_vs_fp32"] is not None for n in measured)


def test_tune_self_diff_has_no_regression(doc, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "bench_diff", _ROOT / "scripts" / "bench_diff.py")
    bd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bd)
    path = write_artifact(tmp_path / "BENCH_testrev.json", doc)
    again = jart.read_artifact(path)
    table, regressions = bd.diff_rows(again, again)
    assert regressions == []
    assert {r["status"] for r in table} == {"ok", "unmeasured"}


def test_unported_tiles_are_est_error_rows():
    """A space with a non-default ``kernel_tuning`` gives a coded row, not
    a crash: ``build`` refuses those tiles until ROADMAP item 5 (b)."""
    base = TS.lite_spec(8, n_points=64, embed_dim=16, k_neighbors=4,
                        precision="fp32")
    bad = base.serving().replace(kernel_tuning=TS.KernelTuning(knn=64))
    invalid = base.serving().replace(grouper="ball",
                                     fused_group="grouped_transfer")
    doc = tune(base, space=[bad, invalid], top_k=1, max_batch=2,
               n_requests=2, rev="t", device="cpu")
    rows = {r["name"]: r for r in doc["rows"]}
    row = rows[tplan.spec_label(bad)]
    assert row["derived"].startswith("NotImplementedError")
    assert "part (b)" in row["derived"] and row["measured_sps"] is None
    assert "RPA010" in rows[tplan.spec_label(invalid)]["derived"]
    assert rows[ANCHOR_NAME]["measured_sps"] is not None

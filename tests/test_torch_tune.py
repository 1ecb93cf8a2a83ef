"""The port's cost model and tuner (``repro_torch.roofline``, ``repro_torch.tune``) held against JAX's.

* ``StagePlan.cost_breakdown``: rows (op, flops, w_bytes, act_bytes)
  exactly ``repro.api.plan``'s for Lite, M-2, Elite fused and unfused
  (and under the "center" affine mode) and the seg head; their FLOPs sum
  to ``pointmlp_flops``.
* ``estimate_plan``: every row bit for bit JAX's under ``CPU_HOST`` and a
  test-local model, but a product row on the port's ``cuda`` backend,
  whose compute term pays the padding of the card's template (computed
  here from each template's tile) where JAX's ``pallas_interpret`` pays
  its Pallas tiles'; the precision ladder ranks under ``H100_SXM`` too.
* ``enumerate_plan_space``: JAX's labels in JAX's order (backend names
  mapped), and JAX's fingerprints where no kernel backend is named.
* ``frontier`` and ``artifact``: copies of ``tests/test_tune.py``'s cases.
* ``tune(device="cpu")`` at 128 points: JAX's ``validate_artifact``
  accepts it, the anchor is on the frontier, a ``ref`` candidate's
  estimate is its JAX twin's (the tile candidates paired in order), a
  ``cuda`` one's is ``estimate_plan`` at the dispatch's batch, the
  measured set is the anchor plus the top-2 estimates, and
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
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

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
from repro_torch.tune.kernels import tuning_candidates

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


# The card's templates, (kernel, BN, small) -> rows a block (BM) on the
# 16-byte route, read off csrc/fused_linear.cu, fp32_wide_tile.cuh and
# csrc/int8_matmul.cu (whose scalar route takes half the rows).
CARD_ROWS = {("fused_linear", 128, False): 128,
             ("fused_linear", 64, False): 128,
             ("fused_linear", 32, False): 256,
             ("fused_linear", 16, False): 256,
             ("fused_linear", 32, True): 32, ("fused_linear", 16, True): 64,
             ("int8_matmul", 128, False): 128,
             ("int8_matmul", 64, False): 256,
             ("int8_matmul", 32, False): 256,
             ("int8_matmul", 16, False): 256}


def pad(dim, tile):
    return -(-dim // tile) * tile / dim


def card_gemm_waste(kernel, m, k, n):
    """One product's padding on the template its wrapper picks (its own
    rule), with aligned operands: M to BM, N to BN, and K to the int8
    kernel's 64-byte chunks."""
    from repro_torch.kernels import fused_linear, int8_matmul
    if kernel == "int8_matmul":
        t = int8_matmul.template(k, n)
        bm = CARD_ROWS[kernel, t.bn, False] // (1 if t.vec else 2)
        return pad(m, bm) * pad(k, 64) * pad(n, t.bn)
    t = fused_linear.template(m, k, n)
    return pad(m, CARD_ROWS[kernel, t.bn, t.small]) * pad(n, t.bn)


def card_waste(plan, cfg, op):
    """The tile waste of a ``cost_breakdown`` row at one cloud a dispatch,
    or None for a row that launches no product kernel on the card (another
    backend, a ``group`` row).  No BREAKDOWN_SPECS plan fuses a ``cuda``
    stage."""
    def gemm(prec, m, k, n):
        return card_gemm_waste("int8_matmul" if prec == "int8"
                               else "fused_linear", m, k, n)
    if op.startswith("stage"):
        s = int(op[5]) - 1
        kind = op.split(".")[1]
        if plan.stage_backend[s] != "cuda" or kind == "group":
            return None
        prec, c = plan.stage_precision[s], cfg.stage_dims[s]
        c_prev = cfg.stage_dims[s - 1] if s else cfg.embed_dim
        smp, k = cfg.stage_samples[s], cfg.k_neighbors
        if kind == "transfer":
            return gemm(prec, smp * k, 2 * c_prev, c)
        mid = max(1, int(c * cfg.res_expansion))
        m = smp * k if kind == "pre" else smp
        return 0.5 * (gemm(prec, m, c, mid) + gemm(prec, m, mid, c))
    if plan.backend != "cuda":
        return None
    if op == "embed":
        return gemm(plan.precision, cfg.n_points, 3, cfg.embed_dim)
    m = cfg.n_points if plan.head == "seg" else 1
    c_in = (cfg.embed_dim + 2 * cfg.stage_dims[-1] if plan.head == "seg"
            else cfg.stage_dims[-1])
    return (gemm(plan.precision, m, c_in, 512)
            + gemm(plan.precision, m, 512, 256)
            + gemm(plan.precision, m, 256, cfg.n_classes)) / 3.0


@pytest.mark.parametrize("hw", sorted(HW))
@pytest.mark.parametrize("name", sorted(BREAKDOWN_SPECS))
def test_estimate_rows_are_jax(plans, name, hw):
    """Each row bit for bit JAX's, but a product row on ``cuda``: its
    compute term pays :func:`card_waste` (the card's templates), where
    JAX's pays its Pallas tiles' padding; the other fields stay JAX's."""
    (tp, t_cfg), (jp, j_cfg) = plans[name]
    t_hw, j_hw = HW[hw]
    got = troof.estimate_plan(tp, t_cfg, t_hw)
    want = jroof.estimate_plan(jp, j_cfg, j_hw)
    assert [r["op"] for r in got.rows] == [r["op"] for r in want.rows]
    kernel_rows = 0
    for g, w in zip(got.to_rows(), want.to_rows()):
        waste = card_waste(tp, t_cfg, g["op"])
        if waste is None:
            assert g == w
            continue
        kernel_rows += 1
        peak = (t_hw.peak_int8_ops if g["precision"] == "int8"
                else t_hw.peak_flops)
        assert g["t_compute"] == pytest.approx(g["flops"] * waste / peak,
                                               rel=1e-12), g["op"]
        assert g["t_bound"] == max(g["t_compute"], g["t_memory"])
        same = ("op", "precision", "flops", "w_bytes", "act_bytes",
                "t_memory")
        assert {f: g[f] for f in same} == {f: w[f] for f in same}
    assert (kernel_rows > 0) == ("cuda" in name)
    if not kernel_rows:
        assert (got.total_s, got.sps, got.bottleneck) == (
            want.total_s, want.sps, want.bottleneck)


def test_tile_waste_reads_the_plan_tuning():
    """On ``cuda`` the compute term pays the card's template padding:
    none on Lite's stages (every M and N a multiple of the pick's BM and
    BN), the head's one row a cloud padded to the small tile's rows; on
    ``ref`` it is 1; and a pinned template (``plan.tuning``) moves it."""
    spec = TS.lite_spec(40, precision="fp32").serving()
    ref = troof.estimate_plan(*lowered_one(spec), troof.CPU_HOST)
    stages = troof.estimate_plan(*lowered_one(spec.replace(
        stage_backend=("cuda",) * 4)), troof.CPU_HOST)
    assert stages.to_rows() == ref.to_rows()
    cuda_spec = spec.replace(stage_backend=("cuda",) * 4, backend="cuda")
    cuda = troof.estimate_plan(*lowered_one(cuda_spec), troof.CPU_HOST)
    assert cuda.t_compute > ref.t_compute and cuda.t_memory == ref.t_memory
    assert troof._ceil_waste(96, 128) == 128 / 96
    pinned = troof.estimate_plan(*lowered_one(cuda_spec.replace(
        kernel_tuning=TS.KernelTuning(fused_linear=(256, 16, 16)))),
        troof.CPU_HOST)
    assert pinned.t_compute != cuda.t_compute
    assert pinned.t_memory == cuda.t_memory


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
    """The quick space carries the tile axis as JAX's does (the defaults
    first, then the card's small tiles), on one device; a tile twin's
    label is JAX's format, its ``/kt=`` token naming the card's tiles."""
    base = TS.lite_spec(40).serving()
    space = quick_space(base)
    assert all(s.data_shards == 1 for s in space)
    assert ([s.kernel_tuning for s in space[:2]]
            == [TS.DEFAULT_TUNING, tuning_candidates(quick=True)[1]])
    assert {s.kernel_tuning for s in space} == set(
        tuning_candidates(quick=True))
    assert {s.stage_backend for s in space} == {("ref",) * 4,
                                                ("cuda",) * 4}
    assert "/kt=" not in tplan.spec_label(space[0])
    assert tplan.spec_label(space[1]).endswith(
        "/kt=32x32x32.gt256.f256.k32")
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


def jax_twin_tuning(kt):
    """JAX's tile candidate at the port's candidate's place in
    ``tuning_candidates`` (the defaults, the small tiles, the large
    ones)."""
    from repro.tune.kernels import tuning_candidates as jax_candidates
    i = tuning_candidates(quick=False).index(kt)
    return jax_candidates(quick=False)[i]


def test_tile_candidates_pair_with_jax():
    """The port's candidate set, JAX's order and size, its labels JAX's
    with the ``/kt=`` token mapped (not dropped)."""
    from repro.tune.kernels import tuning_candidates as jax_candidates
    t_base, j_base = pair("lite_spec", 40, serving=True)
    for quick in (True, False):
        assert len(tuning_candidates(quick)) == len(jax_candidates(quick))
    for kt in tuning_candidates(quick=False):
        jkt = jax_twin_tuning(kt)
        t_label = tplan.spec_label(t_base.replace(kernel_tuning=kt))
        j_label = jplan.spec_label(j_base.replace(kernel_tuning=jkt))
        if kt == TS.DEFAULT_TUNING:
            assert jkt == JS.KernelTuning() and t_label == j_label
            continue
        tm, tk, tn = jkt.fused_linear
        j_token = (f"/kt={tm}x{tk}x{tn}.gt{jkt.grouped_transfer}"
                   f".f{jkt.fps}.k{jkt.knn}")
        tm, tk, tn = kt.fused_linear
        t_token = (f"/kt={tm}x{tk}x{tn}.gt{kt.grouped_transfer}"
                   f".f{kt.fps}.k{kt.knn}")
        assert t_label.endswith(t_token) and j_label.endswith(j_token)
        assert t_label.replace(t_token, j_token) == j_label


@pytest.fixture(scope="module")
def jax_estimates():
    """JAX's CPU_HOST estimate of each twin of the port's quick space
    (tile candidates paired by :func:`jax_twin_tuning`), keyed by the
    port's label, with the port's twin spec."""
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
            over["kernel_tuning"] = jax_twin_tuning(over["kernel_tuning"])
        j = j_base.replace(**over)
        cfg = j.to_model_config()
        est = jroof.estimate_plan(jplan.lower(j, cfg), cfg, jroof.CPU_HOST)
        label = ANCHOR_NAME if t.kernel_tuning is None else \
            tplan.spec_label(t)
        out[label] = (est, t)
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
    # the anchor and the quick space: 10 specs x 2 tile candidates
    assert len(set(names)) == len(names) == 21


def test_tune_follows_jax_estimates(doc, jax_estimates):
    """A ``ref`` candidate's estimate is its JAX twin's (no kernel row,
    so no tile waste on either side); a ``cuda`` one's is
    ``estimate_plan`` at the dispatch's batch (4 clouds: the card's
    templates), not JAX's; the measured set is the anchor plus the two
    candidates estimated fastest."""
    rows = {r["name"]: r for r in doc["rows"]}
    assert set(rows) == set(jax_estimates)
    n_cuda = 0
    for name, (est, spec) in jax_estimates.items():
        if "cuda" in (spec.stage_backend or (spec.backend,)):
            n_cuda += 1
            cfg = spec.to_model_config()
            mine = troof.estimate_plan(tplan.lower(spec, cfg), cfg,
                                       troof.CPU_HOST, batch=4)
            assert rows[name]["estimated_sps"] == mine.sps, name
        else:
            assert rows[name]["estimated_sps"] == est.sps, name
    assert n_cuda == 10
    top2 = sorted((n for n in rows if n != ANCHOR_NAME),
                  key=lambda n: (1 / rows[n]["estimated_sps"],
                                 rows[n]["fingerprint"]))[:2]
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
    """A tile its kernel lacks on the card gives a coded row, not a
    crash (``lower`` raises the ``ValueError`` naming the tiles it has);
    a tile the card has is estimated and measured."""
    base = TS.lite_spec(8, n_points=64, embed_dim=16, k_neighbors=4,
                        precision="fp32")
    bad = base.serving().replace(kernel_tuning=TS.KernelTuning(knn=12))
    good = base.serving().replace(kernel_tuning=TS.KernelTuning(knn=64))
    invalid = base.serving().replace(grouper="ball",
                                     fused_group="grouped_transfer")
    doc = tune(base, space=[bad, good, invalid], top_k=1, max_batch=2,
               n_requests=2, rev="t", device="cpu")
    rows = {r["name"]: r for r in doc["rows"]}
    row = rows[tplan.spec_label(bad)]
    assert row["derived"].startswith("ValueError: knn: the card has no "
                                     "tile 12")
    assert row["measured_sps"] is None and row["estimated_sps"] is None
    measured = rows[tplan.spec_label(good)]
    assert measured["derived"] is None
    assert measured["measured_sps"] is not None
    assert measured["spec"]["kernel_tuning"]["knn"] == 64
    assert "RPA010" in rows[tplan.spec_label(invalid)]["derived"]
    assert rows[ANCHOR_NAME]["measured_sps"] is not None

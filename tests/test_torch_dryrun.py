"""Parity of the port's dry-run (``repro_torch.launch.dryrun``, ``report``)
with ``repro``'s, and of ``seq_parallel``.

* The small functions (``_tree_param_counts``, ``_layer_unit``,
  ``_with_layers``, ``VARIANTS``/``apply_variant``, ``cell_is_runnable``)
  equal JAX's for every full-size arch.
* ``seq_parallel=True`` at the smoke configs of tinyllama and moonshot
  (bf16) is the port's own ``seq_parallel=False`` forward bit for bit,
  and JAX's ``seq_parallel`` forward (under ``jax.set_mesh`` of an
  Auto-axis ``(1, 1)`` mesh, run op by op: XLA's fusions round bf16
  elsewhere and flip near-tied MoE routing) within 4e-2 of max|logit|,
  the LM tests' bf16 bound.
* ``report.py``'s two tables equal JAX's byte for byte on the same
  records, skipped rows included, with a numeric collective term.
* The fake step counts the FLOPs ``FlopCounterMode`` counts over the same
  step run for real on the CPU, exactly, at the smoke configs; xLSTM's
  slow cells are deferred unless asked for.
* moonshot's and maverick's ``moe_local*`` cells count on both meshes
  (the whole view in the ideal partition, rank 0's dispatch in the
  collective term), their ``default`` cells a term of the global route
  (each rank's block, the experts' counts gathered over the data
  group), and a dense arch's cell under ``moe_local`` is its
  ``default`` program.
* The refusals: flash on fake tensors, and ``seq_parallel``/
  ``constrain_batch`` on real tensors an abstract mesh would split.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it is
imported; the ``jdry`` fixture imports it after JAX's backend has
started in this process and restores the variable, so no later JAX test
or child process sees it.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import report as jreport
from repro.configs import LM_SHAPES as JLM
from repro.configs import cell_is_runnable as jax_runnable
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JT
from repro.models.api import get_model as jax_get_model
from repro_torch import report
from repro_torch.configs import (LM_SHAPES, ShapeConfig, cell_is_runnable,
                                 get_config, get_smoke_config, list_archs)
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.context import current_mesh, set_mesh, use_mesh

BF16_ATOL = 4e-2
B, T = 2, 24
TC = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)
MESH = make_production_mesh()
JAX_OPS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute"}


@pytest.fixture(scope="module")
def jdry():
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


# ------------------------------------------------------ small functions --

def test_variants_and_layer_cuts_are_jax(jdry):
    assert list(D.VARIANTS) == list(jdry.VARIANTS)
    for arch in list_archs():
        jcfg, tcfg = jax_config(arch), get_config(arch)
        assert D._layer_unit(tcfg) == jdry._layer_unit(jcfg)
        for n in (1, 2, 8):
            j, t = jdry._with_layers(jcfg, n), D._with_layers(tcfg, n)
            assert (t.n_layers, t.n_enc_layers) == (j.n_layers,
                                                    j.n_enc_layers)
        for v in D.VARIANTS:
            j, t = jdry.apply_variant(jcfg, v), D.apply_variant(tcfg, v)
            for f in ("sharding_profile", "seq_parallel", "attn_impl"):
                assert getattr(t, f) == getattr(j, f), (arch, v, f)
            # the default (disabled) QuantConfig's backend is JAX's "fake",
            # which the port names "int8_ref"
            fields = ("w_bits", "a_bits", "enabled") + (
                ("backend",) if j.quant.enabled else ())
            for f in fields:
                assert getattr(t.quant, f) == getattr(j.quant, f), (arch, v)


def test_cell_is_runnable_is_jax():
    for arch in list_archs():
        for name in LM_SHAPES:
            got = cell_is_runnable(get_config(arch), LM_SHAPES[name])
            assert got == jax_runnable(jax_config(arch), JLM[name])
            assert get_config(arch).is_subquadratic == \
                jax_config(arch).is_subquadratic


def test_tree_param_counts_are_jax(jdry):
    for arch in list_archs():
        jcfg, tcfg = jax_config(arch), get_config(arch)
        jtree = jax.eval_shape(jax_get_model(jcfg).init,
                               jax.random.PRNGKey(0))
        with FakeTensorMode():
            ttree = get_model(tcfg).init(torch.Generator(), device="meta")
        assert D._tree_param_counts(ttree, tcfg) == \
            jdry._tree_param_counts(jtree, jcfg), arch


# --------------------------------------------------------- seq_parallel --

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b"])
def test_seq_parallel_forward(arch):
    jcfg = jax_smoke(arch).replace(seq_parallel=True)
    tcfg = get_smoke_config(arch)
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, T))
    ids = ids.astype(np.int32)
    params = jax.jit(JT.lm_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.disable_jit(), jax.set_mesh(jmesh):
        want, _ = JT.lm_forward(params, jcfg, jnp.asarray(ids))
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params))
    x = torch.from_numpy(ids)
    plain, _ = TT.lm_forward(tp, tcfg, x)
    for mesh in (None, Mesh(("data", "model"), (1, 1))):
        with use_mesh(mesh):
            got, _ = TT.lm_forward(tp, tcfg.replace(seq_parallel=True), x)
        assert torch.equal(got, plain)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_ATOL * np.abs(want).max())


def test_use_mesh_restores_on_raise():
    set_mesh(None)
    with pytest.raises(RuntimeError):
        with use_mesh(MESH):
            assert current_mesh() is MESH
            raise RuntimeError("inside")
    assert current_mesh() is None


# ------------------------------------------------------------- report --

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dry"))
    full = D.run_cell("tinyllama-1.1b", "decode_32k", "pod", out_dir=out)
    fast = D.run_cell("llama3.2-1b", "train_4k", "pod", out_dir=out,
                      fast=True)
    skip = D.run_cell("tinyllama-1.1b", "long_500k", "pod", out_dir=out)
    return out, full, fast, skip


def test_records(records):
    out, full, fast, skip = records
    assert skip["status"] == "skipped" and "full-attention" in \
        skip["reason"]
    for rec in (full, fast):
        on_disk = json.loads(open(os.path.join(
            out, "pod", rec["arch"], rec["shape"] + ".json")).read())
        assert on_disk == json.loads(json.dumps(rec))
        assert rec["n_chips"] == 256 and rec["status"] == "ok"
    r = full["roofline"]
    assert r["t_collective"] > 0 and r["coll_bytes"] > 0
    assert r["coll_wire_bytes"] >= r["coll_wire_bytes_across_nodes"] > 0
    assert set(r["coll_by_type"]) <= JAX_OPS
    assert r["coll_bytes"] == sum(r["coll_by_type"].values())
    assert full["collectives"]["calls"] == \
        sum(full["collectives"]["calls_by_type"].values()) > 0
    assert full["rank_cost"]["flops"] > 0 and full["rank_cost"]["op_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert full["bytes_per_device"] == \
        full["memory"]["argument_size_in_bytes"] + \
        full["memory"]["temp_size_in_bytes"]
    assert r["flops"] == full["global_cost"]["flops"] / 256
    assert "ideal partition" in full["cost_method"]
    assert "ideal partition" in full["temp_method"]
    assert "roofline" not in fast and fast["bytes_per_device"] == \
        fast["memory"]["argument_size_in_bytes"]


def test_report_tables_are_jax(records):
    _, full, fast, skip = records
    got = report.roofline_table([full, skip])
    assert got == jreport.roofline_table([full, skip])
    assert f"| {full['roofline']['t_collective']:.3e} |" in got
    assert "| — |" not in got.splitlines()[2]
    recs = [full, fast, skip]
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert "all-reduce" in report.dryrun_table([full])
    # every counted cell has a numeric term, printed as JAX prints it
    t = full["roofline"]["t_collective"]
    assert report.fmt_t(t) == jreport.fmt_t(t) == f"{t:.3e}"
    assert "int8 tensor-core" in report.bottleneck_summary(
        [dict(full, roofline=dict(full["roofline"],
                                  bottleneck="compute"))])
    assert "MXU" not in "".join(report._IMPROVE.values())


def test_cli_fast_and_report(tmp_path, capsys):
    D.main(["--arch", "tinyllama-1.1b", "--mesh", "both", "--fast",
            "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8 and sum("SKIPPED" in ln for ln in lines) == 2
    assert len(report.load(str(tmp_path), "multipod")) == 4
    report.main(["--dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "2x16x16 (pod=2, data=16, model=16) = 512 devices" in text
    assert text.count("| tinyllama-1.1b | train_4k | ok |") == 2


# -------------------------------------------- the fake step, counted --

def real_operands(api, shape, seed=0):
    """The cell's operands as real CPU tensors (random weights, token ids
    from numpy)."""
    cfg = api.cfg
    rng = np.random.default_rng(seed)
    params = api.init(torch.Generator().manual_seed(seed), device="cpu")
    inputs = {}
    for k, spec in api.input_specs(shape).items():
        if k == "pos":
            inputs[k] = torch.tensor(shape.seq_len - 1, dtype=spec.dtype)
        elif spec.dtype == torch.int32:
            inputs[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, spec.shape).astype(np.int32))
        else:
            inputs[k] = torch.from_numpy(rng.standard_normal(
                spec.shape).astype(np.float32))
    out = {"params": params, "inputs": inputs}
    if shape.kind == "train":
        out["opt"] = TS.build_train_step(api, TC)[1](params)
    else:
        out["cache"] = api.init_cache(shape.global_batch, shape.seq_len,
                                      device="cpu")
    return out


def real_flops(api, shape):
    trees = real_operands(api, shape)
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        D.run_step(api, shape, TC, trees)
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kinds", [
    ("tinyllama-1.1b", ("train", "prefill", "decode")),
    ("moonshot-v1-16b-a3b", ("train", "decode")),
    ("internvl2-26b", ("prefill",)),
    ("xlstm-1.3b", ("train", "decode")),
    ("hymba-1.5b", ("prefill",)),
    ("whisper-tiny", ("train", "decode")),
])
def test_fake_flops_equal_real_cpu_run(arch, kinds):
    cfg = get_smoke_config(arch)
    api = get_model(cfg)
    for kind in kinds:
        shape = ShapeConfig("smoke", kind, 32, 2)
        fake = D.fake_step_cost(api, shape, TC)
        want = real_flops(api, shape)
        assert fake["flops"] == want > 0, (arch, kind)
        assert fake["op_bytes"] > 0 and fake["temp_bytes"] > 0


def test_slow_cells_are_deferred_unless_asked(tmp_path):
    """xLSTM's train and prefill cells run the sLSTM cell once a time
    step; without ``slow`` their record says so (argument bytes kept)."""
    slow = [(arch, name) for arch in list_archs() for name in LM_SHAPES
            if D.slow_cell(get_config(arch), LM_SHAPES[name])]
    assert slow == [("xlstm-1.3b", "train_4k"), ("xlstm-1.3b", "prefill_32k")]
    rec = D.run_cell("xlstm-1.3b", "prefill_32k", "pod",
                     out_dir=str(tmp_path))
    assert rec["status"] == "deferred" and "--slow-cells" in rec["reason"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert "| xlstm-1.3b | prefill_32k | deferred | — |" in \
        report.dryrun_table([rec])
    assert "| xlstm-1.3b | prefill_32k | prefill | — |" in \
        report.roofline_table([rec])


def test_counts_frees_and_views():
    """Traffic: a view moves nothing and allocates nothing; a freed
    temporary leaves the live count; an in-place write moves bytes."""
    with TS.fake_mode():
        x = torch.empty(256, 256, device="meta")
        with D.Traffic() as tr:
            v = x.view(-1)
            assert tr.op_bytes == 0 and tr.peak == 0
            y = x * 2
            n = 256 * 256 * 4
            assert tr.live == tr.peak == n and tr.op_bytes == 2 * n
            del y
            assert tr.live == 0
            x.add_(1.0)
            assert tr.op_bytes == 4 * n and tr.peak == n
            # a kernel's own buffers: the softmax copies a permuted input
            p = torch.softmax(x.t(), -1)
            assert tr.live == n and tr.peak == 2 * n
            g = torch.ops.aten._softmax_backward_data(x.t(), p, -1,
                                                      torch.float32)
            assert tr.live == 2 * n and tr.peak == 2 * n + 2 * n
            lse = torch.logsumexp(x, -1)
            assert tr.peak == 4 * n
            del p, g, lse
        del v


# ------------------------------------------------------------ refusals --

@pytest.mark.parametrize("arch,variant", [
    ("moonshot-v1-16b-a3b", "moe_local"),
    ("llama4-maverick-400b-a17b", "moe_local_sp")])
def test_moe_local_cells_count_on_both_meshes(tmp_path, arch, variant):
    """A ``moe_local*`` decode cell of each MoE arch at full width: the
    ideal partition's count (the whole view) shared by both meshes, rank
    0's program (the per-rank dispatch over model=16) and its collective
    term for each; the ``default`` cell's term is the global route's,
    with the experts' counts gathered over the data group."""
    recs = {m: D.run_cell(arch, "decode_32k", m, out_dir=str(tmp_path),
                          variant=variant) for m in ("pod", "multipod")}
    for m, rec in recs.items():
        r = rec["roofline"]
        assert rec["status"] == "ok" and rec["profile"] == variant
        assert r["flops"] == rec["global_cost"]["flops"] / rec["n_chips"]
        assert r["t_collective"] > 0 and r["t_memory"] > 0
        assert set(r["coll_by_type"]) <= JAX_OPS and \
            r["coll_by_type"]["all-reduce"] > 0
        assert rec["rank_cost"]["flops"] > 0
        assert (tmp_path / m / arch / f"decode_32k.{variant}.json").exists()
    assert recs["pod"]["global_cost"] == recs["multipod"]["global_cost"]
    assert recs["pod"]["params_total"] == (
        778_214_937_600 if "maverick" in arch else 28_057_995_264)
    # the data group has 16 ranks on one pod and 32 on two, so rank 0's
    # block and its term differ by mesh
    assert recs["pod"]["roofline"]["t_collective"] != \
        recs["multipod"]["roofline"]["t_collective"]
    # the global route on the same mesh: rank 0 routes its block of the
    # batch and all-gathers each MoE layer's [16, E] int64 entry counts
    # over the data group of 16
    glob = D.run_cell(arch, "decode_32k", "pod", out_dir=str(tmp_path))
    cfg = get_config(arch)
    assert glob["status"] == "ok" and glob["profile"] == "default"
    assert "collective_reason" not in glob
    assert glob["collectives"]["by_group"]["all-gather int64 x16"] == \
        cfg.n_layers * 16 * cfg.n_experts * 8
    assert glob["roofline"]["t_collective"] > 0
    assert glob["roofline"]["coll_by_type"]["all-reduce"] > 0


def test_dense_arch_under_moe_local_is_its_default_program(tmp_path):
    """``moe_local`` places like ``default`` and changes only the MoE
    layer, so a dense arch's cell counts as its ``default`` one."""
    local = D.run_cell("llama3.2-1b", "decode_32k", "pod",
                       out_dir=str(tmp_path), variant="moe_local")
    plain = D.run_cell("llama3.2-1b", "decode_32k", "pod",
                       out_dir=str(tmp_path))
    assert local["status"] == plain["status"] == "ok"
    assert local["global_cost"] == plain["global_cost"]
    assert local["roofline"] == plain["roofline"]
    assert local["collectives"] == plain["collectives"]
    assert local["memory"]["argument_size_in_bytes"] == \
        plain["memory"]["argument_size_in_bytes"]


def test_moe_local_outside_a_model_mesh_takes_the_global_route():
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 8)).astype(np.int32))
    want, _ = api.forward(params, x)
    local = get_model(cfg.replace(sharding_profile="moe_local"))
    for mesh in (None, Mesh(("data",), (1,))):
        with use_mesh(mesh):
            assert torch.equal(local.forward(params, x)[0], want)
    # on an abstract mesh with a model axis, the whole view: on (1, 1) it
    # is the one block's local dispatch, products and f32 combine
    lcfg = local.cfg
    p = TT.layer_params(params["blocks"], 0)["moe"]
    h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    with use_mesh(Mesh(("data", "model"), (1, 1))):
        y, aux = TM.moe_apply(p, lcfg, h)
        assert local.forward(params, x)[0].shape == want.shape
    xf = h.reshape(-1, cfg.d_model)
    _, top_p, top_e = TM.route(p, lcfg, xf)
    disp = TM.dispatch_local(xf, top_e, 0, cfg.n_experts,
                             TM.local_capacity(lcfg, xf.shape[0]))
    one = TM.combine_local(TM.experts(p, disp.buf), disp, top_p)
    assert torch.equal(y, one.to(h.dtype).reshape(h.shape))
    _, gaux = TM.moe_apply(p, cfg, h)
    assert torch.equal(aux, gaux)


def test_flash_refuses_fake_tensors():
    with torch.no_grad():
        for dev in ("meta", "cuda"):
            with FakeTensorMode():
                q = torch.empty(1, 4, 16, 64, device=dev,
                                dtype=torch.bfloat16)
                with pytest.raises(ValueError, match="fake or meta"):
                    ops.flash_attention(q, q, q)
        q = torch.empty(1, 4, 16, 64, device="meta")
        with pytest.raises(ValueError, match="fake or meta"):
            ops.flash_attention(q, q, q)
    api = get_model(get_smoke_config("tinyllama-1.1b").replace(
        attn_impl="flash"))
    shape = ShapeConfig("smoke", "train", 32, 2)
    with pytest.raises(NotImplementedError, match="no backward"):
        D.fake_step_cost(api, shape, TC)


def test_real_tensors_a_mesh_would_split_are_refused():
    cfg = get_smoke_config("tinyllama-1.1b")
    api = get_model(cfg.replace(seq_parallel=True))
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.zeros(B, 8, dtype=torch.int32)
    with use_mesh(Mesh(("data", "model"), (1, 2))):
        with pytest.raises(ValueError, match="seq_parallel.*abstract mesh"):
            api.forward(params, x)
    # an abstract mesh has no process to hold a block of a real tensor
    # (a batch that does not divide over data=16 stays whole, as in JAX)
    x16 = torch.zeros(16, 8, dtype=torch.int32)
    assert rules.constrain_batch(x, MESH) is x
    with pytest.raises(ValueError, match="abstract"):
        rules.constrain_batch(x16, MESH)
    with use_mesh(MESH):
        cache = api.init_cache(16, 8, device="cpu")
        with pytest.raises(ValueError, match="abstract"):
            TS.build_prefill_step(get_model(cfg))(params, {"tokens": x16},
                                                  cache)
    with FakeTensorMode():
        f = torch.empty(4, 8, device="meta")
        assert rules.constrain_batch(f, MESH) is f

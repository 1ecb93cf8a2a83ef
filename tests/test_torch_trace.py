"""The port's trace pass (``repro_torch.analysis.trace``) held against ``repro.analysis.trace``.

* the planted cases of ``tests/test_analysis.py``'s ``TestTracePass``,
  each as its torch twin, with the code JAX's tests state; where JAX's
  ``trace_callable`` runs, its codes on the same inputs (made with numpy
  from a seed) are the port's.  jax 0.9.0 dropped the ``jax.core.Literal``
  alias that JAX's scan reads, so those comparisons set it to
  ``jax.extend.core.Literal`` for the test's duration (the JAX package
  is not changed), and its float64 case runs under ``jax.enable_x64``;
* the port's own rules: the rounded-once float64 island (RPA201) and
  the exact integer accumulate (RPA202), each clean and caught, and the
  places that use them (``kernels/ref.py``, ``core/knn.py``,
  ``kernels/grouped_transfer.py``);
* ``_build.launch``'s recorder slot (a stub launcher on the CPU, a real
  launch on the card);
* the sharded full dispatch (``serve.sharding.shard_forward``) of the
  shipped Lite spec at 2 shards: the URS host reads (RPA203);
* the CLI's trace stage in a subprocess.
"""
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro_torch.analysis import trace as T
from repro_torch.api import registry as R
from repro_torch.api import spec as TS
from repro_torch.core import knn as knn_core
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import _build, ops, ref
from repro_torch.launch.mesh import Mesh, counting_mesh
from repro_torch.serve.sharding import make_mesh
from repro_torch.sharding import collectives, context

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
SEED = 0


def codes(found):
    return [f.code for f in found]


@pytest.fixture
def J(monkeypatch):
    """The JAX side, imported here so that the file's card tests run on
    a machine without JAX: ``jax``, ``jnp``, JAX's trace module ``T``
    (with the ``jax.core.Literal`` alias its scan reads, removed in jax
    0.9.0, set for the test), its registry ``R``, spec module ``S`` and
    ``QuantConfig``."""
    import jax
    import jax.extend.core
    import jax.numpy as jnp
    from repro.analysis import trace
    from repro.api import registry, spec
    from repro.core.quant import QuantConfig as JQuantConfig
    monkeypatch.setattr(jax.core, "Literal", jax.extend.core.Literal,
                        raising=False)
    return types.SimpleNamespace(jax=jax, jnp=jnp, T=trace, R=registry,
                                 S=spec, QuantConfig=JQuantConfig)


def int8_inputs(jnp=None):
    """``TestTracePass.INT8_PARAMS``' shapes and x [2, 8], as numpy from a
    seed: (torch tree, torch x, jax tree, jax x), the JAX pair None
    without ``jnp``."""
    rng = np.random.default_rng(SEED)
    q = rng.integers(-127, 128, (8, 4)).astype(np.int8)
    scale = (rng.random((1, 4)) * 0.01 + 1e-3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    tp = {"w": {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)},
          "b": torch.from_numpy(b)}
    if jnp is None:
        return tp, torch.from_numpy(x), None, None
    jp = {"w": {"q": jnp.asarray(q), "scale": jnp.asarray(scale)},
          "b": jnp.asarray(b)}
    return tp, torch.from_numpy(x), jp, jnp.asarray(x)


def tiny(module, **over):
    """``tests/test_analysis.py``'s ``tiny_spec`` in either package."""
    base = dict(n_points=128, embed_dim=16, k_neighbors=8,
                precision="fp32", backend="ref")
    base.update(over)
    return module.lite_spec(8).serving().replace(**base)


# ------------------------------------------------------------------ #
# the planted cases of tests/test_analysis.py                        #
# ------------------------------------------------------------------ #

class TestPlanted:
    def test_planted_silent_upcast_caught(self, J):
        tp, tx, jp, jx = int8_inputs(J.jnp)

        def bad(p, x):               # raw q used as float weights
            return x @ p["w"]["q"].to(x.dtype) + p["b"]

        def jbad(p, x):
            return x @ p["w"]["q"].astype(x.dtype) + p["b"]
        got = T.trace_callable(bad, tp, tx, where="planted")
        assert codes(got) == ["RPA202"]
        assert "aten::mm" in got[0].message
        assert codes(got) == codes(J.T.trace_callable(
            jbad, jp, jx, where="planted"))

    def test_dequant_idiom_stays_clean(self, J):
        tp, tx, jp, jx = int8_inputs(J.jnp)

        def good(p, x):
            w = p["w"]["q"].to(x.dtype) * p["w"]["scale"]
            return x @ w + p["b"]

        def jgood(p, x):
            w = p["w"]["q"].astype(x.dtype) * p["w"]["scale"]
            return x @ w + p["b"]
        assert T.trace_callable(good, tp, tx, where="ok") == []
        assert J.T.trace_callable(jgood, jp, jx, where="ok") == []

    def test_int8_ref_backend_stays_clean(self, J):
        tp, tx, jp, jx = int8_inputs(J.jnp)
        fn = R.BACKENDS.get("ref")
        q = QuantConfig(w_bits=8, a_bits=8, backend="int8_ref")
        assert T.trace_callable(lambda p, x: fn(p, x, q, True), tp, tx,
                                where="int8_ref") == []
        jfn = J.R.BACKENDS.get("ref")
        jq = J.QuantConfig(w_bits=8, a_bits=8, backend="int8_ref")
        assert J.T.trace_callable(lambda p, x: jfn(p, x, jq, True),
                                  jp, jx, where="int8_ref") == []

    def test_int8_kernel_backend_plain_version_stays_clean(self):
        """The ``cuda`` backend's int8 path on CPU tensors runs
        ``ref.int8_matmul_ref``: an exact integer accumulate in a
        float64 island, both sanctioned."""
        tp, tx, _, _ = int8_inputs()
        fn = R.BACKENDS.get("cuda")
        q = QuantConfig(w_bits=8, a_bits=8, backend="int8_cuda")
        traces = []
        assert T.trace_callable(lambda p, x: fn(p, x, q, True), tp, tx,
                                where="int8_cuda", traces=traces) == []
        names = [op.name for op in traces[0].ops]
        assert "aten::mm" in names and traces[0].islands == 1

    def test_f64_caught(self, J):
        x = np.random.default_rng(SEED).standard_normal(4).astype(
            np.float32)
        got = T.trace_callable(lambda v: v.double() * 2.0,
                               torch.from_numpy(x), where="f64")
        assert codes(got) == ["RPA201"]
        assert "output" in got[0].message
        with J.jax.enable_x64(True):
            want = J.T.trace_callable(
                lambda v: v.astype(J.jnp.float64) * 2.0, J.jnp.asarray(x),
                where="f64")
        assert codes(got) == codes(want)

    def test_data_axis_collective_caught(self):
        """JAX's verdict: a psum over ``"data"`` is RPA204.  Here the
        all-reduce over a counting mesh's ``"data"`` group (rank 0's
        program, nothing moved); one over ``"model"`` is clean."""
        mesh = counting_mesh(Mesh(("data", "model"), (2, 2)))
        x = torch.ones(2, 4)

        def over(axis):
            return lambda v: collectives.all_sum(
                v, collectives.process_group(mesh, axis))
        found = T.trace_callable(over("data"), x, where="psum")
        assert codes(found) == ["RPA204"]
        assert "('data',)" in found[0].message
        assert T.trace_callable(over("model"), x, where="psum") == []

    def test_process_groups_carry_their_axes(self):
        """A group over processes (here a stand-in ``DeviceMesh``) is
        logged with the axes ``process_group`` made it for, as a counting
        group is."""
        class DeviceMesh:
            def get_group(self, axis):
                return types.SimpleNamespace(axis=axis)
        mesh = Mesh(("data", "model"), (2, 2), DeviceMesh())
        group = collectives.process_group(mesh, "data")
        assert collectives.group_axes(group) == ("data",)
        assert collectives.group_axes(object()) == ()
        counting = counting_mesh(Mesh(("data", "model"), (2, 2)))
        assert collectives.group_axes(collectives.process_group(
            counting, ("data", "model"))) == ("data", "model")

    @pytest.mark.parametrize("kind", ["item", "rand"])
    def test_host_read_and_rng_in_shard_region_caught(self, kind):
        """JAX's verdict: a host callback inside a sharded region is
        RPA203 and legal outside one.  The port's twins: ``.item()`` and
        a live ``torch.rand``."""
        def item(v):
            return v * v.sum().item()

        def rand(v):
            return v + torch.rand(v.shape)
        fn = {"item": item, "rand": rand}[kind]
        x = torch.ones(4)
        found = T.trace_callable(fn, x, where="cb", in_shard_region=True)
        assert codes(found) == ["RPA203"]
        assert "test_torch_trace.py:" in found[0].message
        assert T.trace_callable(fn, x, where="cb") == []

    def test_mesh_data_axis_makes_a_sharded_region(self):
        """Without ``in_shard_region``, an op runs sharded while the
        current mesh splits ``"data"`` over more than one device."""
        def fn(v, mesh):
            with context.use_mesh(mesh):
                return v * v.sum().item()
        x = torch.ones(4)
        two = make_mesh(2, devices=("cpu",) * 2)
        one = make_mesh(1, devices=("cpu",))
        assert codes(T.trace_callable(fn, x, two)) == ["RPA203"]
        assert T.trace_callable(fn, x, one) == []

    def test_untraceable_callable_is_a_finding(self, J):
        def boom(v):
            raise RuntimeError("no trace for you")
        got = T.trace_callable(boom, torch.ones(4), where="boom")
        assert codes(got) == ["RPA209"]
        assert codes(got) == codes(J.T.trace_callable(
            boom, J.jnp.ones(4), where="boom"))

    @pytest.mark.parametrize("over", [
        dict(),
        dict(precision="int8"),
        dict(fused_group="grouped_transfer"),
        dict(stage_precision=("int8", "int8", "int8", "fp32")),
        dict(head="seg"),
    ])
    def test_shipped_plans_trace_clean(self, over, J):
        traces = []
        assert T.analyze_plan_trace(tiny(TS, **over), traces=traces) == []
        assert traces and all(tr.n_aten for tr in traces)
        assert J.T.analyze_plan_trace(tiny(J.S, **over)) == []


# ------------------------------------------------------------------ #
# the port's own rules                                               #
# ------------------------------------------------------------------ #

def int8_codes(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 10), -127, 127).to(torch.int8)


class TestPortRules:
    def test_exact_integer_accumulate_is_clean(self):
        tp, tx, _, _ = int8_inputs()

        def acc(p, x):
            xq = int8_codes(x)
            a = (xq.double() @ p["w"]["q"].double()).to(torch.int32)
            return a.float() * p["w"]["scale"]
        traces = []
        assert T.trace_callable(acc, tp, tx, traces=traces) == []
        assert traces[0].islands == 1

    def test_accumulate_kept_in_float_caught(self):
        tp, tx, _, _ = int8_inputs()

        def kept(p, x):
            xq = int8_codes(x)
            return (xq.double() @ p["w"]["q"].double()).float()
        assert codes(T.trace_callable(kept, tp, tx)) == ["RPA202"]

    def test_accumulate_with_a_float_operand_caught(self):
        """Only integer times integer is exact: a float operand makes the
        same pattern RPA202."""
        tp, tx, _, _ = int8_inputs()

        def mixed(p, x):
            return (x.double() @ p["w"]["q"].double()).to(torch.int32)
        assert codes(T.trace_callable(mixed, tp, tx)) == ["RPA202"]

    def test_converted_value_used_twice_caught(self):
        tp, tx, _, _ = int8_inputs()

        def twice(p, x):
            xq = int8_codes(x).double()
            a = (xq @ p["w"]["q"].double()).to(torch.int32)
            return a.float() + xq.sum().float()
        assert codes(T.trace_callable(twice, tp, tx)) == ["RPA202"]

    def test_f64_island_rounded_back_is_clean(self):
        traces = []
        x = torch.ones(4)
        assert T.trace_callable(lambda v: (v.double() * 2.0).float(), x,
                                traces=traces) == []
        assert traces[0].islands == 1

    @pytest.mark.parametrize("case", ["mask", "host", "int64"])
    def test_f64_leaving_its_island_unrounded_caught(self, case):
        def mask(v):
            return v[v.double() > 0.5]

        def host(v):
            return v * float(v.double().sum())

        def int64(v):
            return v.double().to(torch.int64)
        fn = {"mask": mask, "host": host, "int64": int64}[case]
        found = T.trace_callable(fn, torch.arange(4.0))
        assert codes(found) == ["RPA201"]
        assert "leaves its island" in found[0].message

    def test_f64_input_caught(self):
        found = T.trace_callable(lambda v: v.float(),
                                 torch.ones(4, dtype=torch.float64))
        assert codes(found) == ["RPA201"]
        assert "input" in found[0].message

    @pytest.mark.parametrize("per_sample", [True, False])
    def test_knn_sigma_is_two_islands(self, per_sample):
        off = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (2, 4, 3, 5)).astype(np.float32))
        traces = []
        assert T.trace_callable(
            lambda o: knn_core.group_sigma(o, per_sample), off,
            traces=traces) == []
        assert traces[0].islands == 2

    def test_int8_matmul_plain_version_is_one_island(self):
        rng = np.random.default_rng(SEED)
        x_q = torch.from_numpy(rng.integers(-127, 128, (6, 8)).astype(
            np.int8))
        w_q = torch.from_numpy(rng.integers(-127, 128, (8, 4)).astype(
            np.int8))
        a_scale = torch.full((3,), 0.02)
        w_scale = torch.full((4,), 0.01)
        traces = []
        assert T.trace_callable(ref.int8_matmul_ref, x_q, w_q, a_scale,
                                w_scale, 2, traces=traces) == []
        assert traces[0].islands == 1

    def test_grouped_transfer_stats_plain_version_is_clean(self):
        rng = np.random.default_rng(SEED)
        feats = torch.from_numpy(rng.standard_normal((2, 10, 4)).astype(
            np.float32))
        nidx = torch.from_numpy(rng.integers(0, 10, (2, 3, 5)))
        centers = feats[:, :3].contiguous()
        alpha, beta = torch.ones(4), torch.zeros(4)
        w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
        traces = []
        assert T.trace_callable(
            lambda *a: ref.grouped_transfer_ref(*a[:3], None, *a[3:]),
            feats, nidx, centers, alpha, beta, w, torch.zeros(6),
            traces=traces) == []
        assert traces[0].islands == 2       # group_sigma's


# ------------------------------------------------------------------ #
# _build.launch's recorder slot                                      #
# ------------------------------------------------------------------ #

class TestLaunchRecorder:
    def stub(self, monkeypatch, calls):
        class Device:
            def __init__(self, dev):
                pass

            def __enter__(self):
                pass

            def __exit__(self, *exc):
                pass

        monkeypatch.setattr(torch.cuda, "device", Device)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev: types.SimpleNamespace(cuda_stream=5))
        monkeypatch.setattr(_build, "launcher",
                            lambda name: lambda *a: calls.append(a) or 0)

    def test_stub_launch_is_named_in_the_stream(self, monkeypatch):
        calls = []
        self.stub(monkeypatch, calls)

        def fn(x, w):
            y = x * 2.0                       # prologue
            out = torch.empty(3)
            _build.launch("fused_linear", torch.device("cuda", 0),
                          y.data_ptr(), w.data_ptr(), out.data_ptr(), 3)
            return out + 1.0                  # epilogue
        x, w = torch.ones(3), torch.ones(3)
        traces = []
        assert T.trace_callable(fn, x, w, traces=traces) == []
        tr = traces[0]
        names = [op.name for op in tr.ops]
        at = names.index("launch:fused_linear")
        assert names.index("aten::mul") < names.index("aten::empty") < at
        assert names[at + 1:] == ["aten::add"]
        assert tr.launches == {"fused_linear": 1}
        launch = tr.ops[at]
        # reads the prologue's result, the argument w and the buffer
        made = {tr.ops[tr.values[v].producer].name for v in launch.ins
                if tr.values[v].producer is not None}
        assert {"aten::mul", "aten::empty"} <= made
        assert [tr.values[v].arg for v in launch.ins].count(True) == 1
        assert launch.outs == ()
        assert len(calls) == 1 and calls[0][-1] == 5
        assert _build.RECORDER is None

    def test_slot_is_empty_outside_a_trace(self, monkeypatch):
        calls = []
        self.stub(monkeypatch, calls)
        assert _build.RECORDER is None
        _build.launch("knn", torch.device("cuda", 0), 1, 2)
        assert calls == [(1, 2, 5)]

        def boom(v):
            raise RuntimeError("x")
        T.trace_callable(boom, torch.ones(2))
        assert _build.RECORDER is None

    def test_launch_reading_int8_raw_weights_is_a_consumer(self,
                                                          monkeypatch):
        """An opaque launch that reads a silently upcast value consumes
        it: RPA202, as any other consumer."""
        self.stub(monkeypatch, [])

        def fn(q):
            wf = q.to(torch.float32)
            _build.launch("fused_linear", torch.device("cuda", 0),
                          wf.data_ptr())
            return wf
        found = T.trace_callable(fn, torch.ones(4, dtype=torch.int8))
        assert codes(found) == ["RPA202"]
        assert "launch:fused_linear" in found[0].message

    @pytest.mark.cuda
    def test_card_launch_is_recorded(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU "
                        "mode)")
        g = torch.Generator().manual_seed(SEED)
        x, w, b = (torch.randn(s, generator=g).cuda()
                   for s in ((4, 8), (8, 16), (16,)))
        traces = []
        assert T.trace_callable(ops.fused_linear, x, w, b,
                                traces=traces) == []
        tr = traces[0]
        assert tr.launches == {"fused_linear": 1}
        launch = next(op for op in tr.ops
                      if op.name == "launch:fused_linear")
        assert len(launch.ins) >= 4      # x, w, b and the output buffer


# ------------------------------------------------------------------ #
# the sharded full dispatch                                          #
# ------------------------------------------------------------------ #

def test_sharded_lite_dispatch_reports_the_urs_host_reads():
    """The shipped Lite spec at ``data_shards=2`` on the CPU: each shard
    draws its URS indices on the host (``core/sampling.py``), one
    ``Tensor.numpy`` a stage a shard; the unsharded dispatch, which runs
    in no sharded region, is clean."""
    from repro_torch.api.build import build
    from repro_torch.models.pointmlp import pointmlp_init
    spec = TS.lite_spec(40).serving()
    params = pointmlp_init(spec.to_model_config(),
                           torch.Generator().manual_seed(SEED))
    pts = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (4, spec.n_points, 3)).astype(np.float32))
    found = {}
    for n in (1, 2):
        mesh = make_mesh(n, devices=("cpu",) * n) if n > 1 else None
        pipe = build(spec.replace(data_shards=n), params, device="cpu",
                     mesh=mesh)
        found[n] = T.analyze_sharded_callable(
            pipe.infer, pts, pipe.seed_state(SEED, 4), where=f"lite/{n}")
    assert found[1] == []
    assert codes(found[2]) == ["RPA203"]
    assert ("Tensor.numpy at repro_torch/core/sampling.py:41 x8"
            in found[2][0].message)


# ------------------------------------------------------------------ #
# imports and the CLI                                                #
# ------------------------------------------------------------------ #

def _run(*argv, code=None):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = ([sys.executable, "-c", code] if code is not None
           else [sys.executable, "-m", "repro_torch.analysis", *argv])
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_trace_module_imports_neither_jax_nor_repro():
    out = _run(code=(
        "import sys, repro_torch.analysis.trace\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"))
    assert out.returncode == 0, out.stderr


def test_cli_runs_the_trace_stage_per_variant():
    out = _run("--all-variants")
    assert out.returncode == 0, out.stdout + out.stderr
    specs = [ln.split()[2].rstrip(":") for ln in out.stdout.splitlines()
             if ln.startswith("== spec ")]
    traced = [ln.split()[2].rstrip(":") for ln in out.stdout.splitlines()
              if ln.startswith("== trace ")]
    assert len(specs) == 9 and traced == specs
    assert all(f"== trace {s}: ok" in out.stdout for s in specs)
    assert out.stdout.splitlines()[-1] == (
        "SUMMARY: 10 finding(s), 0 error(s) [codes: none]")


def test_cli_no_trace_omits_the_stage():
    out = _run("--spec-json", "{}", "--no-contracts", "--no-trace")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "== spec pointmlp-lite: ok" in out.stdout
    assert "== trace" not in out.stdout


def test_cli_error_finding_stops_before_the_trace():
    out = _run("--spec-json", '{"data_shards": 2}', "--no-contracts")
    assert out.returncode == 1
    assert "RPA020" in out.stdout and "== trace" not in out.stdout
    assert "[codes: RPA020]" in out.stdout

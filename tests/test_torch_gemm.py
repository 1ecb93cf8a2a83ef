"""The GEMM kernels' templates and dispatch shapes (``int8_matmul``, ``fused_linear``).

``csrc/int8_matmul.cu`` and ``csrc/fused_linear.cu`` are templates on the
column tile and the load route, and the wrappers pick one
(``kernels/int8_matmul.py::template``, ``kernels/fused_linear.py::
template``).  On the CPU these tests hold the choice to its rules at every
product of a 32-cloud dispatch of Lite, M-2 and Elite, recorded through
the plain versions, and hold the C launch functions' template switches to
the Python encoding.

Tests marked ``cuda`` run the kernels on the card and skip without one;
they import no JAX, so they also run on a GPU machine without it
(``python -m pytest -m cuda tests/test_torch_gemm.py``).  Tolerances:
``int8_matmul`` bitwise against its plain version (exact integer sums,
the same f32 dequantize); ``fused_linear`` bitwise against itself at
another tile and against ``grouped_transfer``'s product (both are one
in-order fmaf chain an output), and within rtol = atol = 1e-5 of its
plain version (cuBLAS sums in another order).
"""
import collections
import re

import numpy as np
import pytest
import torch

from repro_torch.api.build import build
from repro_torch.api.spec import elite_spec, lite_spec, m2_spec
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import fused_linear as fl_mod
from repro_torch.kernels import int8_matmul as i8_mod
from repro_torch.models.pointmlp import pointmlp_init

BATCH = 32
# (M, K, N) -> launches in one 32-cloud dispatch.
M2_SHAPES = {
    (16384, 512, 512): 1, (32768, 256, 256): 1, (65536, 128, 128): 1,
    (16384, 512, 128): 1, (16384, 128, 512): 1, (131072, 64, 64): 1,
    (32768, 256, 64): 2, (32768, 64, 256): 2,
    (65536, 128, 32): 1, (65536, 32, 128): 1, (131072, 64, 16): 1,
    (131072, 16, 64): 1,
    (1024, 512, 128): 1, (1024, 128, 512): 1, (2048, 256, 64): 2,
    (2048, 64, 256): 2,
    (4096, 128, 32): 1, (4096, 32, 128): 1, (8192, 64, 16): 1,
    (8192, 16, 64): 1,
    (32, 512, 512): 1, (32, 512, 256): 1, (16384, 3, 32): 1}
LITE_SHAPES = {**M2_SHAPES, (32, 256, 40): 1}
ELITE_SHAPES = {
    (32768, 3, 32): 1, (262144, 64, 16): 1, (262144, 16, 64): 1,
    (16384, 64, 16): 1, (16384, 16, 64): 1, (131072, 128, 32): 1,
    (131072, 32, 128): 1, (8192, 128, 32): 1, (8192, 32, 128): 1,
    (65536, 256, 64): 2, (65536, 64, 256): 2, (4096, 256, 64): 2,
    (4096, 64, 256): 2, (32768, 512, 128): 1, (32768, 128, 512): 1,
    (2048, 512, 128): 1, (2048, 128, 512): 1, (32, 512, 512): 1,
    (32, 512, 256): 1}
RAGGED = [(1, 1, 1), (77, 3, 33), (231, 40, 24), (1000, 100, 200),
          (300, 17, 130), (4097, 20, 500), (5, 1024, 7), (129, 48, 16)]
ALL_SHAPES = sorted({*LITE_SHAPES, *ELITE_SHAPES, *RAGGED})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# ----------------------------------------------------------- templates --

def launch_table(name):
    """tmpl code -> (BN, small, vec), from the launch function's switch in
    ``csrc/<name>.cu``."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    cases = re.findall(r"case (\d+): return launch<(\d+), (\w+)(?:, (\w+))?>",
                       text)
    table = {}
    for code, bn, a, b in cases:
        small, vec = (a, b) if b else ("false", a)
        table[int(code)] = (int(bn), small == "true", vec == "true")
    return table


@pytest.mark.parametrize("name", ["int8_matmul", "fused_linear"])
def test_template_codes_match_the_launch_switch(name):
    """Every template the wrapper can pick reaches the C instantiation of
    the same tile, smallness and route."""
    table = launch_table(name)
    smalls = (False, True) if name == "fused_linear" else (False,)
    for bn in _build.TILE_WIDTHS:
        for small in smalls:
            if small and bn > 32:
                continue
            for vec in (False, True):
                t = _build.GemmTemplate(bn, vec, small)
                assert table[t.code] == (bn, small, vec), t.name
    assert len(table) == (12 if name == "fused_linear" else 8)


@pytest.mark.parametrize("m,k,n", ALL_SHAPES)
def test_int8_template_rules(m, k, n):
    t = i8_mod.template(k, n)
    assert t.bn == min(b for b in _build.TILE_WIDTHS if b >= min(n, 128))
    assert not t.small
    # 16-byte copies need rows of x_q and w_q on 16-byte boundaries
    assert t.vec == (k % 16 == 0 and n % 4 == 0)
    assert not i8_mod.template(k, n, aligned=False).vec
    if k == 3:
        assert not t.vec


@pytest.mark.parametrize("m,k,n", ALL_SHAPES)
def test_fused_linear_template_rules(m, k, n):
    t = fl_mod.template(m, k, n)
    wide_bn = min(b for b in _build.TILE_WIDTHS if b >= min(n, 128))
    wide_rows = 256 if wide_bn <= 32 else 128
    wide_blocks = -(-m // wide_rows) * -(-n // wide_bn)
    # the small tile only where the wide one leaves half the SMs idle
    assert t.small == (2 * wide_blocks <= fl_mod.H100_SMS)
    assert t.bn == ((16 if n <= 16 else 32) if t.small else wide_bn)
    assert t.vec == (k % 4 == 0 and n % 4 == 0)
    assert not fl_mod.template(m, k, n, aligned=False).vec
    if k == 3:
        assert not t.vec


def test_int8_wrapper_rejects_k_past_the_slice():
    k = i8_mod.MAX_K + 16
    x_q = torch.zeros(4, k, dtype=torch.int8)
    w_q = torch.zeros(k, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="shared memory"):
        i8_mod.int8_matmul_cuda(x_q, w_q, torch.ones(1), torch.ones(8), 4)


# ------------------------------------------------- dispatch shapes -----

def record_dispatch(monkeypatch, spec, n_points):
    """(kernel, M, K, N) of every GEMM launch one 32-cloud dispatch of
    ``spec`` makes, recorded on the CPU through the plain versions."""
    shapes = []
    int8_ref, fused_ref = ref.int8_matmul_ref, ref.fused_linear_ref

    def int8_rec(x_q, w_q, a_scale, w_scale, rows_per_lane):
        shapes.append(("int8_matmul", *x_q.shape, w_q.shape[1]))
        assert a_scale.numel() == BATCH
        return int8_ref(x_q, w_q, a_scale, w_scale, rows_per_lane)

    def fused_rec(x, w, b, activation="relu"):
        shapes.append(("fused_linear", *x.shape, w.shape[1]))
        return fused_ref(x, w, b, activation)

    monkeypatch.setattr(ref, "int8_matmul_ref", int8_rec)
    monkeypatch.setattr(ref, "fused_linear_ref", fused_rec)
    spec = spec.replace(backend="cuda")
    params = pointmlp_init(spec.to_model_config(),
                           torch.Generator().manual_seed(0))
    pipe = build(spec, params, device="cpu")
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(
        rng.standard_normal((BATCH, n_points, 3)).astype(np.float32))
    logits, _ = pipe.infer(pts, pipe.seed_state(0, BATCH))
    assert logits.shape == (BATCH, 40) and bool(torch.isfinite(logits).all())
    return shapes


@pytest.mark.parametrize("name,spec,n_points,kernel,want", [
    ("lite", lite_spec(40).serving(), 512, "int8_matmul", LITE_SHAPES),
    ("m2", m2_spec(40).serving(), 512, "fused_linear", M2_SHAPES),
    ("elite", elite_spec(40).serving().replace(
        fused_group="grouped_transfer"), 1024, "fused_linear",
     ELITE_SHAPES)])
def test_dispatch_gemm_shapes(monkeypatch, name, spec, n_points, kernel,
                              want):
    """A dispatch launches one GEMM kernel, 28 / 27 / 23 times, at
    exactly the shapes that the templates above are held to."""
    shapes = record_dispatch(monkeypatch, spec, n_points)
    assert {s[0] for s in shapes} == {kernel}
    got = collections.Counter(s[1:] for s in shapes)
    assert got == collections.Counter(want)
    assert len(shapes) == {"lite": 28, "m2": 27, "elite": 23}[name]


# ------------------------------------------------------------- on card --

def int8_case(dev, m, k, n, lanes, seed, offset=0):
    """Random int8 operands and scales on ``dev``; x_q starts ``offset``
    bytes into its storage (so an odd offset leaves it unaligned)."""
    g = torch.Generator().manual_seed(seed)
    store = torch.randint(-127, 128, (m * k + offset,), generator=g,
                          dtype=torch.int8)
    x_q = store.to(dev)[offset:].view(m, k)
    w_q = torch.randint(-127, 128, (k, n), generator=g,
                        dtype=torch.int8).to(dev)
    a_scale = (torch.rand(lanes, generator=g) / 127 + 1e-4).to(dev)
    w_scale = (torch.rand(n, generator=g) / 127 + 1e-4).to(dev)
    return x_q, w_q, a_scale, w_scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,lanes,offset", [
    *[(m, k, n, BATCH, 0) for m, k, n in LITE_SHAPES],
    (231, 40, 24, 3, 0), (1000, 100, 200, 8, 0), (1200, 16, 48, 4, 0),
    (4097, 20, 500, 17, 0), (300, 17, 130, 1, 0), (5, 1024, 7, 5, 0),
    (1000, 64, 20, 8, 0), (96, 512, 132, 3, 0),
    (777, 64, 64, 3, 1), (512, 32, 32, 2, 3)])
def test_int8_bitwise_on_card(cuda_device, m, k, n, lanes, offset):
    """Bitwise at every Lite shape and at ragged M, N and K, with
    rows_per_lane not a multiple of the row tile, and unaligned x_q."""
    x_q, w_q, a_scale, w_scale = int8_case(cuda_device, m, k, n, lanes,
                                           m + k + n, offset)
    rpl = m // lanes
    before = i8_mod.int8_matmul_cuda.launches
    got = i8_mod.int8_matmul_cuda(x_q, w_q, a_scale, w_scale, rpl)
    want = ref.int8_matmul_ref(x_q, w_q, a_scale, w_scale, rpl)
    torch.cuda.synchronize()
    assert i8_mod.int8_matmul_cuda.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32, 2048, 65536])
@pytest.mark.parametrize("k", [3, 64, 512])
@pytest.mark.parametrize("act", ["relu", "gelu", "none"])
def test_fused_linear_tile_invariance_on_card(cuda_device, m, k, act):
    """Column j of an N = 16 layer equals column j of the same weights
    zero-padded to N = 64 and 128 (other tiles, other templates), and a
    row alone equals the row in its batch, bit for bit; all within
    rtol = atol = 1e-5 of the plain version."""
    g = torch.Generator().manual_seed(m + k)
    x = torch.randn(m, k, generator=g).to(cuda_device)
    w = (torch.randn(k, 16, generator=g) / k ** 0.5).to(cuda_device)
    b = (0.1 * torch.randn(16, generator=g)).to(cuda_device)
    got = ops.fused_linear(x, w, b, act)
    torch.testing.assert_close(got, ref.fused_linear_ref(x, w, b, act),
                               rtol=1e-5, atol=1e-5)
    for n in (64, 128):
        wide = fl_mod.template(m, k, n)
        assert wide.bn != fl_mod.template(m, k, 16).bn
        w_pad = torch.nn.functional.pad(w, (0, n - 16))
        b_pad = torch.nn.functional.pad(b, (0, n - 16))
        padded = ops.fused_linear(x, w_pad, b_pad, act)
        assert torch.equal(padded[:, :16], got)
    assert torch.equal(ops.fused_linear(x[5:6], w, b, act), got[5:6])


@pytest.mark.cuda
@pytest.mark.parametrize("c,c_out", [(32, 64), (256, 512)])
def test_fused_linear_equals_grouped_transfer_on_card(cuda_device, c,
                                                      c_out):
    """On the same normalized rows, fused_linear and grouped_transfer with
    sigma given compute the same product, bit for bit."""
    from repro_torch.core import knn as knn_core
    from repro_torch.core import sampling
    from repro_torch.kernels import grouped_transfer as gt_mod
    dev = cuda_device
    g = torch.Generator().manual_seed(c)
    bsz, n, s, k = 4, 256, 64, 16
    feats = torch.randn(bsz, n, c, generator=g).to(dev)
    centers_idx = torch.stack([torch.randperm(n, generator=g)[:s]
                               for _ in range(bsz)]).to(dev)
    centers = sampling.gather_points(feats, centers_idx).contiguous()
    nbr = torch.randint(0, n, (bsz, s, k), generator=g).to(dev)
    alpha = (0.7 + 0.6 * torch.rand(c, generator=g)).to(dev)
    beta = (0.1 * torch.randn(c, generator=g)).to(dev)
    w = (torch.randn(2 * c, c_out, generator=g) / (2 * c) ** 0.5).to(dev)
    bias = (0.1 * torch.randn(c_out, generator=g)).to(dev)
    off = knn_core.gather_neighbors(feats, nbr) - centers[:, :, None, :]
    sigma = knn_core.group_sigma(off, per_sample=True).reshape(-1)
    rows = knn_core.normalize_group(
        knn_core.gather_neighbors(feats, nbr), centers,
        {"alpha": alpha, "beta": beta}, "affine", per_sample=True)
    rows = torch.cat([rows, centers[:, :, None, :].expand_as(rows)], dim=-1)
    got = ops.fused_linear(rows, w, bias, "relu")
    want = gt_mod.grouped_transfer_cuda(feats, nbr, centers,
                                        sigma.contiguous(), alpha, beta, w,
                                        bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)

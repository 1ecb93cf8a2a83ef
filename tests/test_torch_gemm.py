"""The GEMM kernels' templates and dispatch shapes (``int8_matmul``, ``fused_linear``, ``grouped_transfer``), and ``w8_matmul``'s routes.

``csrc/int8_matmul.cu`` and ``csrc/fused_linear.cu`` are templates on the
column tile and the load route, and the wrappers pick one
(``kernels/int8_matmul.py::template``, ``kernels/fused_linear.py::
template``); ``csrc/grouped_transfer.cu`` runs ``fused_linear``'s wide
tile (``csrc/fp32_wide_tile.cuh``) under the same rule.  On the CPU these
tests hold the choice to its rules at every product of a 32-cloud
dispatch of Lite, M-2 and Elite, recorded through the plain versions,
hold the C launch functions' template switches to the Python encoding,
and check that the build hashes the shared header.  ``w8_matmul``'s
route rule and its mirror of the C launch switch and stream sizes are
checked on the CPU; its card tests hold each route to the plain version
(see the W8A16 section).

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
from repro_torch.kernels import grouped_transfer as gt_mod
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
    (32, 512, 512): 1, (32, 512, 256): 1, (16384, 3, 32): 1,
    (32, 256, 40): 1}
LITE_SHAPES = M2_SHAPES
# The seg head (n_classes = 50, ShapeNetPart's part labels) runs its
# classifier per point: fc1 over [embed, upsampled, global] (K = 32 + 2 *
# 512 = 1056), fc2, and fc3 at N = 50, in place of the cls head's rows.
LITE_SEG_SHAPES = {
    **{s: c for s, c in M2_SHAPES.items()
       if s not in ((32, 512, 512), (32, 512, 256), (32, 256, 40))},
    (16384, 1056, 512): 1, (16384, 512, 256): 1, (16384, 256, 50): 1}
ELITE_SHAPES = {
    (32768, 3, 32): 1, (262144, 64, 16): 1, (262144, 16, 64): 1,
    (16384, 64, 16): 1, (16384, 16, 64): 1, (131072, 128, 32): 1,
    (131072, 32, 128): 1, (8192, 128, 32): 1, (8192, 32, 128): 1,
    (65536, 256, 64): 2, (65536, 64, 256): 2, (4096, 256, 64): 2,
    (4096, 64, 256): 2, (32768, 512, 128): 1, (32768, 128, 512): 1,
    (2048, 512, 128): 1, (2048, 128, 512): 1, (32, 512, 512): 1,
    (32, 512, 256): 1, (32, 256, 40): 1}
RAGGED = [(1, 1, 1), (77, 3, 33), (231, 40, 24), (1000, 100, 200),
          (300, 17, 130), (4097, 20, 500), (5, 1024, 7), (129, 48, 16)]
ALL_SHAPES = sorted({*LITE_SHAPES, *LITE_SEG_SHAPES, *ELITE_SHAPES,
                     *RAGGED})


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


@pytest.mark.parametrize("name", ["int8_matmul", "fused_linear",
                                  "grouped_transfer"])
def test_template_codes_match_the_launch_switch(name):
    """Every template the wrapper can pick reaches the C instantiation of
    the same tile, smallness and route (``grouped_transfer`` takes
    ``fused_linear``'s codes and runs the wide tile of the same BN where
    they name the small one)."""
    table = launch_table(name)
    smalls = (False,) if name == "int8_matmul" else (False, True)
    for bn in _build.TILE_WIDTHS:
        for small in smalls:
            if small and bn > 32:
                continue
            for vec in (False, True):
                t = _build.GemmTemplate(bn, vec, small)
                runs_small = small and name == "fused_linear"
                assert table[t.code] == (bn, runs_small, vec), t.name
    assert len(table) == (8 if name == "int8_matmul" else 12)


def test_wide_kernels_share_the_header_under_their_own_names():
    """Both wide kernels are built on ``fp32_wide_tile.cuh`` and keep
    distinct ``__global__`` names (the smoke's profile sums device time
    by name), and ``grouped_transfer.cu`` has no other product kernel."""
    fl = (_build.CSRC / "fused_linear.cu").read_text()
    gt = (_build.CSRC / "grouped_transfer.cu").read_text()
    for text in (fl, gt):
        assert '#include "fp32_wide_tile.cuh"' in text
        assert "wide_tile<BN, VEC>(" in text
    assert "fused_linear_wide_kernel(" in fl
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?"
                         r"\s+(\w+)\(", gt)
    assert kernels == ["grouped_transfer_stats_kernel",
                       "grouped_transfer_wide_kernel"]


def test_build_hash_covers_the_shared_header(tmp_path):
    """Editing ``csrc/*.cuh`` changes the library path of every source
    (so a stale build is never loaded); the hash follows the text, not
    the directory."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")):
        (csrc / f.name).write_bytes(f.read_bytes())
    names = ("fused_linear", "grouped_transfer")
    before = {n: _build._target(n, csrc)[0] for n in names}
    assert before == {n: _build._target(n)[0] for n in names}
    header = csrc / "fp32_wide_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n, csrc)[0] for n in names}
    for n in names:
        assert after[n] != before[n], n
        assert after[n].name.startswith(f"{n}-")


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
    """K past the kernel's 1024-byte w slice is taken (the kernel walks K
    in slices), and ``_check`` still rejects what the kernel cannot
    take: mismatched K, non-int8 operands, rows_per_lane not dividing M
    and scales of the wrong size."""
    k = 2048
    x_q = torch.zeros(4, k, dtype=torch.int8)
    w_q = torch.zeros(k, 8, dtype=torch.int8)
    i8_mod._check(x_q, w_q, torch.ones(1), torch.ones(8), 4)
    with pytest.raises(ValueError, match="needs w_q"):
        i8_mod._check(x_q, w_q[:-16], torch.ones(1), torch.ones(8), 4)
    with pytest.raises(ValueError, match="int8 operands"):
        i8_mod._check(x_q.float(), w_q, torch.ones(1), torch.ones(8), 4)
    with pytest.raises(ValueError, match="rows_per_lane"):
        i8_mod._check(x_q, w_q, torch.ones(1), torch.ones(8), 3)
    with pytest.raises(ValueError, match="a_scale needs"):
        i8_mod._check(x_q, w_q, torch.ones(2), torch.ones(8), 4)
    # on a CPU tensor the kernel wrapper refuses (the device), not K
    with pytest.raises(ValueError, match="CUDA"):
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
    want = ((BATCH, n_points, spec.n_classes) if spec.head == "seg"
            else (BATCH, spec.n_classes))
    assert logits.shape == want and bool(torch.isfinite(logits).all())
    return shapes


# (B*S*k, C, C_out) of the group->transfer products of one 32-cloud Elite
# dispatch, one launch each: stages 1-4.
ELITE_GROUPED = [(262144, 32, 64), (131072, 64, 128), (65536, 128, 256),
                 (32768, 256, 512)]


def test_grouped_transfer_template_at_elite_dispatch(monkeypatch):
    """Recorded through the plain version, Elite's four fused products
    take ``fused_linear``'s template for the same (M, 2C, C_out): the
    wide tile with 16-byte loads, BN 64 at stage 1 and 128 at 2-4."""
    shapes = []
    plain = ref.grouped_transfer_ref

    def rec(feats, nidx, centers, sigma, alpha, beta, w, b, **kw):
        bsz, s, k = nidx.shape
        shapes.append((bsz * s * k, feats.shape[-1], w.shape[1]))
        assert _build.aligned16(feats, centers, alpha, beta, w)
        return plain(feats, nidx, centers, sigma, alpha, beta, w, b, **kw)

    monkeypatch.setattr(ref, "grouped_transfer_ref", rec)
    spec = elite_spec(40).serving().replace(
        backend="cuda", fused_group="grouped_transfer")
    params = pointmlp_init(spec.to_model_config(),
                           torch.Generator().manual_seed(0))
    pipe = build(spec, params, device="cpu")
    pts = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, 1024, 3)).astype(np.float32))
    logits, _ = pipe.infer(pts, pipe.seed_state(0, BATCH))
    assert bool(torch.isfinite(logits).all())
    assert shapes == ELITE_GROUPED
    for (m, c, c_out), bn in zip(shapes, (64, 128, 128, 128)):
        t = gt_mod.template(m, c, c_out)
        assert t == fl_mod.template(m, 2 * c, c_out)
        assert t == _build.GemmTemplate(bn, True, False)
    # C % 4 != 0 takes the scalar route, whatever fused_linear would take
    assert not gt_mod.template(262144, 6, 64).vec
    assert fl_mod.template(262144, 12, 64).vec


@pytest.mark.parametrize("name,spec,n_points,kernel,want", [
    ("lite", lite_spec(40).serving(), 512, "int8_matmul", LITE_SHAPES),
    ("m2", m2_spec(40).serving(), 512, "fused_linear", M2_SHAPES),
    ("elite", elite_spec(40).serving().replace(
        fused_group="grouped_transfer"), 1024, "fused_linear",
     ELITE_SHAPES),
    ("lite_seg", lite_spec(50, head="seg").serving(), 512, "int8_matmul",
     LITE_SEG_SHAPES)])
def test_dispatch_gemm_shapes(monkeypatch, name, spec, n_points, kernel,
                              want):
    """A dispatch launches one GEMM kernel, 28 / 28 / 24 / 28 times, at
    exactly the shapes that the templates above are held to (the head's
    fc3 included: on the ``cuda`` backend it runs on the head's kernel)."""
    shapes = record_dispatch(monkeypatch, spec, n_points)
    assert {s[0] for s in shapes} == {kernel}
    got = collections.Counter(s[1:] for s in shapes)
    assert got == collections.Counter(want)
    assert len(shapes) == {"lite": 28, "m2": 28, "elite": 24,
                           "lite_seg": 28}[name]


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
    (777, 64, 64, 3, 1), (512, 32, 32, 2, 3),
    # K past one 1024-byte w slice: lite_spec(40, embed_dim=128)'s
    # stage-4 transfer depth, several M tiles a block, a partial last
    # slice, and the scalar route
    (4096, 2048, 512, BATCH, 0), (4096, 2048, 2048, BATCH, 0),
    (600, 1100, 72, 3, 0), (257, 1027, 40, 1, 0), (64, 4096, 128, 2, 1),
    # the Lite seg head: fc1 at K = 1056 (a 32-byte last slice), fc3 at
    # N = 50 (N % 4 != 0: the scalar route)
    *[(m, k, n, BATCH, 0) for m, k, n in ((16384, 1056, 512),
                                          (16384, 512, 256),
                                          (16384, 256, 50))]])
def test_int8_bitwise_on_card(cuda_device, m, k, n, lanes, offset):
    """Bitwise at every Lite shape and at ragged M, N and K, with
    rows_per_lane not a multiple of the row tile, unaligned x_q, and K
    past the kernel's shared-memory slice."""
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
@pytest.mark.parametrize("m,k,n", [(32768, 1056, 512), (32768, 512, 256),
                                   (2048, 256, 50)])
def test_fused_linear_seg_head_products_on_card(cuda_device, m, k, n):
    """The Elite seg head's per-point fc1 (K = 1056) and fc2, and an
    N = 50 product (the scalar route), within rtol = atol = 1e-5 of the
    plain version, and a row alone bitwise equal to its row in the
    batch."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(cuda_device)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(cuda_device)
    b = (0.1 * torch.randn(n, generator=g)).to(cuda_device)
    assert fl_mod.template(m, k, n).vec == (n % 4 == 0)
    got = ops.fused_linear(x, w, b, "relu")
    torch.testing.assert_close(got, ref.fused_linear_ref(x, w, b, "relu"),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(ops.fused_linear(x[7:8], w, b, "relu"), got[7:8])


@pytest.mark.cuda
@pytest.mark.parametrize("c,c_out", [(32, 64), (64, 128), (128, 256),
                                     (256, 512), (16, 40), (20, 40),
                                     (10, 30)])
def test_fused_linear_equals_grouped_transfer_on_card(cuda_device, c,
                                                      c_out):
    """On the same normalized rows, fused_linear and grouped_transfer with
    sigma given compute the same product, bit for bit: at Elite's four
    stage widths, where a 16-k step straddles C (C = 20), and on the
    scalar route (C % 4 != 0)."""
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


# ------------------------------------------------------------- W8A16 --
#
# ``csrc/w8_matmul.cu`` has three routes (``kernels/int8_matmul.py::
# w8_route``): ``stream`` (split-K int8 weight stream, few rows),
# ``wgmma`` (bf16 tensor cores, the int8 tile widened in shared memory)
# and ``tiled`` (every other shape).  Card tolerance, per output row
# against ``ref.w8_matmul_plain``: |got - want| <= tol |want| + tol max
# |want| of the row, tol = 2**-7 in bf16 (an output near a rounding
# boundary may land one bf16 step away: the sums run in another order)
# and 1e-5 in f32 (f32 sums over K in another order than cuBLAS).

W8_UP, W8_DOWN = (2048, 5632), (5632, 2048)   # tinyllama's MLP (K, N)
W8_RULE_SHAPES = [
    (1, *W8_UP), (4, *W8_UP), (8192, *W8_UP), (1, *W8_DOWN),
    (4, *W8_DOWN), (8192, *W8_DOWN), (16, *W8_UP), (17, *W8_UP),
    (37, 100, 70), (4, 1000, 512), (300, 1000, 512), (4, 2048, 5648),
    (300, 2048, 5648), (4, 40, 16), (4, 8, 16), (128, 8, 16), (3, 0, 16),
    (4, 100000, 16), (9, 1000, 512), (64, 100, 64), (2, 512, 70)]


def w8_launch_table():
    """route code -> route name, from the launch switch of
    ``csrc/w8_matmul.cu``."""
    text = (_build.CSRC / "w8_matmul.cu").read_text()
    return {int(code): name for code, name in re.findall(
        r"case (\d+):\s*return (?:is_bf16 \?\s*)?launch_(\w+)", text)}


def test_w8_route_codes_match_the_launch_switch():
    """Every route the wrapper can pick reaches the C launch function of
    the same name."""
    assert w8_launch_table() == {i8_mod.W8Route(name).code: name
                                 for name in i8_mod.W8_ROUTES}


def test_w8_stream_sizes_mirror_the_kernel():
    """The split rule's strip width, rows a block and longest split are
    the stream kernel's own constants."""
    text = (_build.CSRC / "w8_matmul.cu").read_text()
    body = text[text.index("namespace stream {"):]
    body = body[:body.index("}  // namespace stream")]
    consts = {name: int(v) for name, v in
              re.findall(r"(\w+) = (\d+)", body)}
    assert consts["COLS"] == i8_mod._STREAM_COLS
    assert consts["MR_MAX"] == i8_mod._STREAM_ROWS[torch.float32]
    assert consts["MMA_ROWS"] == i8_mod._STREAM_ROWS[torch.bfloat16]
    assert consts["KS_MAX"] == i8_mod._STREAM_KS_MAX
    assert consts["TX"] * 16 == consts["COLS"]
    assert consts["TX"] * consts["TY"] == consts["THREADS"]


@pytest.mark.parametrize("m,k,n", W8_RULE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8_route_rules(m, k, n, dtype):
    """stream for at most STREAM_MAX_M rows, wgmma for more rows of bf16
    x with K % 8 == 0, both only on 16-byte aligned data with N % 16 ==
    0; tiled otherwise.  A stream split takes a multiple of 16 rows of w,
    at most KS_MAX, none is empty, and there are no more splits than K /
    32 rounded up."""
    r = i8_mod.w8_route(m, k, n, dtype)
    fast = k > 0 and n % 16 == 0
    if fast and m <= i8_mod.STREAM_MAX_M:
        want = "stream"
    elif fast and dtype == torch.bfloat16 and k % 8 == 0:
        want = "wgmma"
    else:
        want = "tiled"
    assert r.name == want
    assert i8_mod.w8_route(m, k, n, dtype, aligned=False).name == "tiled"
    if r.name != "stream":
        assert r.ks == 0 and r.splits(k) == 1
        return
    splits = r.splits(k)
    assert r.ks % 16 == 0 and r.ks <= i8_mod._STREAM_KS_MAX
    assert (splits - 1) * r.ks < k <= splits * r.ks
    assert splits <= -(-k // 32)


@pytest.mark.parametrize("k,n", [W8_UP, W8_DOWN])
@pytest.mark.parametrize("m", [1, 2, 4, 8, 16])
def test_w8_stream_fills_the_card(m, k, n):
    """At tinyllama's MLP shapes the stream route's grid gives every one
    of an H100's 132 SMs at least two blocks."""
    r = i8_mod.w8_route(m, k, n, torch.bfloat16)
    assert r.name == "stream"
    blocks = (-(-n // i8_mod._STREAM_COLS) * r.splits(k)
              * -(-m // i8_mod._STREAM_ROWS[torch.bfloat16]))
    assert blocks >= 2 * 132


W8_CARD_CASES = [
    # tinyllama's MLP up- and down-projection, decode and prefill
    *[(m, *kn, torch.bfloat16, 0) for kn in (W8_UP, W8_DOWN)
      for m in (1, 4, 8192)],
    # each side of the stream/wgmma threshold, bf16 and f32
    (i8_mod.STREAM_MAX_M, *W8_UP, torch.bfloat16, 0),
    (i8_mod.STREAM_MAX_M + 1, *W8_UP, torch.bfloat16, 0),
    (i8_mod.STREAM_MAX_M, *W8_DOWN, torch.float32, 0),
    (i8_mod.STREAM_MAX_M + 1, *W8_DOWN, torch.float32, 0),
    # K not a multiple of the 64-deep tile or of a split, K below a tile
    (4, 1000, 512, torch.bfloat16, 0), (300, 1000, 512, torch.bfloat16, 0),
    (9, 1000, 512, torch.bfloat16, 0), (3, 2056, 5632, torch.bfloat16, 0),
    (4, 8, 16, torch.bfloat16, 0), (128, 8, 16, torch.bfloat16, 0),
    # N not a multiple of the 128-column strip or tile
    (4, 2048, 5648, torch.bfloat16, 0), (300, 2048, 5648, torch.bfloat16, 0),
    (2, 512, 272, torch.float32, 0),
    # the unaligned shape, ragged N, unaligned x
    (37, 100, 70, torch.bfloat16, 0), (37, 100, 70, torch.float32, 0),
    (300, 1024, 512, torch.bfloat16, 1), (4, 2048, 512, torch.bfloat16, 1),
    # f32 x
    (4, *W8_UP, torch.float32, 0), (1, *W8_DOWN, torch.float32, 0),
    (8, *W8_UP, torch.float32, 0), (300, 1000, 512, torch.float32, 0)]


@pytest.mark.cuda
class TestW8A16:
    @pytest.mark.parametrize("m,k,n,dtype,offset", W8_CARD_CASES)
    def test_routes_match_plain_on_card(self, cuda_device, m, k, n, dtype,
                                        offset):
        """Each route within the row-wise tolerance of the plain version,
        one launch a call, and two launches equal bit for bit (the
        stream route adds its K splits in a fixed order)."""
        g = torch.Generator().manual_seed(m + k + n)
        # offset > 0 starts x off a 16-byte boundary
        x = torch.empty(m * k + offset, dtype=dtype,
                        device=cuda_device)[offset:].view(m, k)
        x.copy_(torch.randn(m, k, generator=g).to(dtype))
        w_q = torch.randint(-127, 128, (k, n), generator=g,
                            dtype=torch.int8).to(cuda_device)
        w_scale = (torch.rand(n, generator=g) / 127 + 1e-4).to(cuda_device)
        route = i8_mod.w8_route(m, k, n, dtype,
                                _build.aligned16(x, w_q, w_scale))
        if offset:
            assert route.name == "tiled"
        before = i8_mod.w8_matmul_cuda.launches
        got = i8_mod.w8_matmul_cuda(x, w_q, w_scale)
        again = i8_mod.w8_matmul_cuda(x, w_q, w_scale)
        want = ref.w8_matmul_plain(x, w_q, w_scale)
        torch.cuda.synchronize()
        assert i8_mod.w8_matmul_cuda.launches == before + 2
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, again), route.name
        tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        g32, w32 = got.float(), want.float()
        allowed = tol * w32.abs() + tol * w32.abs().amax(-1, keepdim=True)
        assert bool(torch.isfinite(g32).all()), route.name
        worst = ((g32 - w32).abs() - allowed).max().item()
        assert worst <= 0, (route.name, worst)

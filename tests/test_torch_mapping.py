"""The mapping kernels, ``knn`` and ``fps``, against their plain versions.

CPU tests hold the plain versions (``repro_torch.kernels.ref.knn_ref`` and
``fps_ref``) to a numpy float32 evaluation in the same rounding order,
hold the selection rule that ``csrc/knn.cu`` implements (a stable sort by
(distance, index), then the float maximum's re-picks) to ``knn_select``,
hold the ball query's fill (a pick farther than the radius becomes pick
0, judged on the pick's own distance) to a numpy loop, and check the
wrappers' refusals and their mirror of the kernels' sizes.

Tests marked ``cuda`` run the kernels on the card and skip without one.
They assert bitwise equality with the plain version and one launch, with
and without a radius (``radius=inf`` must give the kNN indices).  The
file imports no JAX and nothing of ``repro``, so it also runs on a GPU
machine without them::

    python3 -m pytest -m cuda tests/test_torch_mapping.py
"""
import ctypes
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# by path: the import check below runs this file with src/ alone on the path
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from repro_torch.core import knn as tknn
from repro_torch.core.knn import knn_select
from repro_torch.kernels import _build, ref
from repro_torch.kernels import fps as fps_mod
from repro_torch.kernels import knn as knn_mod

F32 = np.float32
FLT_MAX = np.finfo(F32).max
# (S, N) of each kNN stage at k = 16, and (N, S) of each FPS stage, in a
# dispatch of 32 clouds.
LITE_KNN = [(256, 512), (128, 256), (64, 128), (32, 64)]
ELITE_KNN = [(512, 1024), (256, 512), (128, 256), (64, 128)]
ELITE_FPS = [(1024, 512), (512, 256), (256, 128), (128, 64)]
# (S, N) of the seg head's 1-NN upsample (k = 1): Lite's, Elite's.
SEG_UPSAMPLE = [(512, 32), (1024, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# ------------------------------------------------------------- numpy --

def sqdist_numpy(smp, pts):
    """[S, C], [N, C] -> [S, N] float32: s2 - 2*cross + p2, each channel
    sum left to right, every operation rounded to float32."""
    def dot(a, b):
        acc = a[..., 0] * b[..., 0]
        for c in range(1, a.shape[-1]):
            acc = acc + a[..., c] * b[..., c]
        return acc
    s2 = dot(smp, smp)[:, None]
    p2 = dot(pts, pts)[None, :]
    cross = dot(smp[:, None, :], pts[None, :, :])
    return (s2 - F32(2) * cross) + p2


def knn_numpy(smp, pts, k):
    """[B, S, C], [B, N, C] -> [B, S, k]: the first k of a stable sort."""
    return np.stack([np.argsort(sqdist_numpy(s, p), axis=1,
                                kind="stable")[:, :k]
                     for s, p in zip(smp, pts)])


def fps_numpy(pts, n_samples):
    """The in-order FPS loop on one cloud at a time, in float32."""
    b, n, _ = pts.shape
    out = np.zeros((b, n_samples), np.int64)
    for i in range(b):
        dist = np.full(n, np.inf, F32)
        last = 0
        for s in range(1, n_samples):
            diff = pts[i] - pts[i, last]
            sq = diff * diff
            dist = np.minimum(dist, (sq[:, 0] + sq[:, 1]) + sq[:, 2])
            last = int(np.argmax(dist))
            out[i, s] = last
    return out


def select_like_kernel(d, k):
    """csrc/knn.cu's selection in numpy: the first k of a stable sort by
    (distance, index) while they are below FLT_MAX; from the first that
    is not, every pick is the lowest index among the picks so far and
    that candidate (if it is exactly FLT_MAX, or nothing is picked yet)."""
    out = []
    for row in d:
        order = np.argsort(row, kind="stable")
        picks = []
        for r in range(k):
            j = int(order[r])
            if not row[j] < FLT_MAX:
                extra = [j] if (row[j] == FLT_MAX or r == 0) else []
                picks += [min(picks + extra)] * (k - r)
                break
            picks.append(j)
        out.append(picks)
    return np.array(out, np.int64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def grid_cloud(rng, b, n, c, span=3):
    """Integer-grid points: many exact distance ties."""
    return rng.integers(-span, span + 1, (b, n, c)).astype(F32)


# -------------------------------------------------------- CPU: plain --

class TestKnnPlain:
    @pytest.mark.parametrize("kind", ["normal", "grid", "zero"])
    @pytest.mark.parametrize("c", [3, 5, 8])
    def test_knn_ref_is_a_stable_sort(self, kind, c):
        rng = np.random.default_rng(c)
        b, n, s, k = 3, 70, 20, 16
        if kind == "normal":
            pts = rng.standard_normal((b, n, c)).astype(F32)
        elif kind == "grid":
            pts = grid_cloud(rng, b, n, c)
        else:
            pts = np.zeros((b, n, c), F32)
        smp = pts[:, rng.permutation(n)[:s]]
        got = ref.knn_ref(t(smp), t(pts), k).numpy()
        np.testing.assert_array_equal(got, knn_numpy(smp, pts, k))
        if kind == "zero":
            np.testing.assert_array_equal(got[0], np.tile(np.arange(k),
                                                          (s, 1)))

    @pytest.mark.parametrize("n,k", [(37, 1), (37, 37), (64, 1),
                                     (64, 64), (5, 5)])
    def test_knn_ref_k_one_and_k_n(self, n, k):
        rng = np.random.default_rng(n + k)
        pts = grid_cloud(rng, 2, n, 3, span=2)
        smp = rng.standard_normal((2, 9, 3)).astype(F32)
        got = ref.knn_ref(t(smp), t(pts), k).numpy()
        np.testing.assert_array_equal(got, knn_numpy(smp, pts, k))
        if k == n:
            assert (np.sort(got, axis=-1) == np.arange(n)).all()

    @pytest.mark.parametrize("case", range(6))
    def test_kernel_rule_at_the_float_maximum(self, case):
        """Rows with fewer than k distances below FLT_MAX: knn_select's
        re-picks equal the kernel's closed form."""
        rng = np.random.default_rng(case)
        n, k = 24, [3, 8, 16, 24, 24, 1][case]
        row_kinds = []
        for _ in range(6):
            v = rng.standard_normal(n).astype(F32)
            pick = rng.integers(0, 3, n)
            v[pick == 1] = FLT_MAX
            v[pick == 2] = np.inf
            row_kinds.append(v)
        row_kinds.append(np.full(n, np.inf, F32))              # all inf
        row_kinds.append(np.full(n, FLT_MAX, F32))             # all max
        only = np.full(n, np.inf, F32)
        only[[5, 17]] = FLT_MAX                                # 2 maxima
        row_kinds.append(only)
        ties = np.where(rng.random(n) < 0.5, F32(1), np.inf).astype(F32)
        ties[3] = -0.0                                         # -0 == +0
        ties[9] = 0.0
        row_kinds.append(ties)
        d = np.stack(row_kinds)
        want = knn_select(t(d), k).numpy()
        np.testing.assert_array_equal(select_like_kernel(d, k), want)


class TestBallPlain:
    @pytest.mark.parametrize("radius", [0.25, 1.0, 3.0])
    @pytest.mark.parametrize("kind", ["normal", "grid"])
    def test_knn_ref_radius_matches_numpy(self, radius, kind):
        rng = np.random.default_rng(int(radius * 4))
        pts = (grid_cloud(rng, 2, 70, 3, span=2) if kind == "grid"
               else rng.standard_normal((2, 70, 3)).astype(F32))
        smp = pts[:, :12] + F32(0.1) * rng.standard_normal(
            (2, 12, 3)).astype(F32)
        r2 = F32(radius) * F32(radius)
        got = ref.knn_ref(t(smp), t(pts), 10, radius).numpy()
        for b in range(2):
            d = sqdist_numpy(smp[b], pts[b])
            picks = knn_numpy(smp[b:b + 1], pts[b:b + 1], 10)[0]
            want = np.where(np.take_along_axis(d, picks, 1) <= r2, picks,
                            picks[:, :1])
            np.testing.assert_array_equal(got[b], want)
        if radius < 3:
            assert (got[..., 1:] == got[..., :1]).any(), "no pick filled"

    @pytest.mark.parametrize("k", [3, 8, 24])
    def test_fill_judges_a_repick_by_its_own_distance(self, k):
        """At the float maximum's re-picks (``knn_select``'s overwrite
        rule) the fill reads the re-picked point's own distance: the
        rule csrc/knn.cu implements with the key of the pick that first
        chose it."""
        rng = np.random.default_rng(k)
        n = 24
        rows = []
        for finite in range(1, 9):      # row i: i + 1 finite distances
            v = np.where(rng.random(n) < 0.5, FLT_MAX, np.inf).astype(F32)
            v[rng.choice(n, finite, replace=False)] = rng.random(finite) * 4
            rows.append(v)
        d = np.stack(rows)
        idx = knn_select(t(d), k).numpy()
        got = tknn_ball_fill(d, idx, 2.0)
        want = np.where(np.take_along_axis(d, idx, 1) <= F32(2), idx,
                        idx[:, :1])
        np.testing.assert_array_equal(got, want)
        # where knn_select re-picks an earlier point, that pick is kept
        # when its distance is inside the ball, unlike a test of the
        # FLT_MAX it was selected at
        assert ((d < FLT_MAX).sum(1) < k).any()

    def test_radius_squared_in_float32(self):
        assert tknn.radius_sq(None) == float("inf")
        assert tknn.radius_sq(float("inf")) == float("inf")
        assert tknn.radius_sq(0.1) == float(F32(0.1) * F32(0.1))
        assert tknn.radius_sq(0.1) != 0.1 * 0.1
        with pytest.raises(ValueError, match="positive"):
            tknn.radius_sq(float("nan"))


def tknn_ball_fill(d, idx, r2):
    return tknn.ball_fill(t(d), t(idx), r2).numpy()


class TestFpsPlain:
    @pytest.mark.parametrize("kind", ["normal", "padded", "duplicates",
                                      "grid"])
    def test_fps_ref_matches_numpy_loop(self, kind):
        rng = np.random.default_rng(7)
        b, n, s = 3, 90, 40
        if kind == "grid":
            pts = grid_cloud(rng, b, n, 3, span=2)
        else:
            pts = rng.standard_normal((b, n, 3)).astype(F32)
        if kind == "padded":
            pts[1] = 0
        if kind == "duplicates":
            pts[:, n // 2:] = pts[:, :n - n // 2]
        got = ref.fps_ref(t(pts), s).numpy()
        np.testing.assert_array_equal(got, fps_numpy(pts, s))
        if kind == "padded":
            assert (got[1] == 0).all()

    @pytest.mark.parametrize("n,s", [(1, 1), (7, 1), (7, 7), (33, 33)])
    def test_fps_ref_edges(self, n, s):
        pts = np.random.default_rng(n).standard_normal((2, n, 3)).astype(F32)
        got = ref.fps_ref(t(pts), s).numpy()
        np.testing.assert_array_equal(got, fps_numpy(pts, s))
        if s == n:          # every point once
            assert (np.sort(got, axis=-1) == np.arange(n)).all()


# ----------------------------------------------------- CPU: wrappers --

class TestWrappers:
    def test_knn_refusals(self):
        x = torch.zeros(2, 8, 3)
        with pytest.raises(ValueError, match="C <= 8"):
            knn_mod.knn_cuda(torch.zeros(1, 4, 9), torch.zeros(1, 8, 9), 2)
        with pytest.raises(ValueError, match="k <= N"):
            knn_mod.knn(x, x, 9)
        with pytest.raises(ValueError, match="k <= N"):
            knn_mod.knn(x, x, 0)
        with pytest.raises(ValueError, match="batch and channel"):
            knn_mod.knn(x, torch.zeros(3, 8, 3), 2)
        with pytest.raises(ValueError, match="CUDA"):
            knn_mod.knn_cuda(x, x, 2)
        with pytest.raises(ValueError, match="float32"):
            knn_mod.knn_cuda(x.double(), x.double(), 2)
        with pytest.raises(ValueError, match="unsupported devices"):
            knn_mod.knn(x.to("meta"), x.to("meta"), 2)
        with pytest.raises(ValueError, match="radius must be positive"):
            knn_mod.knn_cuda(x, x, 2, radius=-1.0)

    def test_fps_refusals(self):
        with pytest.raises(ValueError, match=r"C = 3"):
            fps_mod.fps_cuda(torch.zeros(1, 8, 4), 2)
        with pytest.raises(ValueError, match="n_samples >= 1"):
            fps_mod.fps(torch.zeros(1, 8, 3), 0)
        with pytest.raises(ValueError, match="N >= 1"):
            fps_mod.fps(torch.zeros(1, 0, 3), 1)
        with pytest.raises(ValueError, match=r"\[B, N, C\]"):
            fps_mod.fps(torch.zeros(8, 3), 2)
        with pytest.raises(ValueError, match="CUDA"):
            fps_mod.fps_cuda(torch.zeros(1, 8, 3), 2)
        with pytest.raises(ValueError, match="float32"):
            fps_mod.fps_cuda(torch.zeros(1, 8, 3, dtype=torch.float64), 2)
        with pytest.raises(ValueError, match="unsupported device"):
            fps_mod.fps(torch.zeros(1, 8, 3, device="meta"), 2)

    def test_any_n_and_k_on_the_cpu(self):
        """No size refusal is left: past the old limits (kNN N > 4842,
        FPS N > 8192) the CPU path answers."""
        rng = np.random.default_rng(3)
        pts = t(rng.standard_normal((1, 9000, 3)).astype(F32))
        assert fps_mod.fps(pts, 4).shape == (1, 4)
        smp = pts[:, :3].contiguous()
        assert knn_mod.knn(smp, pts, 100).shape == (1, 3, 100)

    def test_wrappers_mirror_the_kernel_sizes(self):
        """The wrappers size scratch from constants of the C sources."""
        def const(name, text):
            return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                                 text).group(1))
        knn_src = (_build.CSRC / "knn.cu").read_text()
        fps_src = (_build.CSRC / "fps.cu").read_text()
        assert (const("ROUND_MAX_BLOCKS", knn_src)
                * const("ROUND_WARPS", knn_src)) == knn_mod._ROUND_ROWS
        assert (const("SMEM_BYTES", knn_src)
                // (4 * const("ROUND_WARPS", knn_src))
                == knn_mod._SMEM_ROW_FLOATS)
        assert (const("PT", fps_src) * const("MAX_THREADS", fps_src)
                == fps_mod._REGISTER_POINTS)

    def test_launch_signatures(self):
        """ctypes argument lists match the C launch functions."""
        for name in ("knn", "fps"):
            symbol, argtypes = _build.SIGNATURES[name]
            text = (_build.CSRC / f"{name}.cu").read_text()
            params = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                               text).group(1).split(",")
            kinds = [("P" if "*" in p else "L" if "long long" in p
                      else "F" if "float" in p else "I") for p in params]
            want = [{ctypes.c_void_p: "P", ctypes.c_longlong: "L",
                     ctypes.c_int: "I", ctypes.c_float: "F"}[a]
                    for a in argtypes]
            assert kinds == want, name

    @pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
    def test_ab_build_binds_the_shipped_signatures(self, name):
        """scripts/ab_build.py, which the A/B scripts bind every source
        through, reads each shipped launch function as _build binds it."""
        path = (pathlib.Path(__file__).resolve().parents[1] / "scripts"
                / "ab_build.py")
        spec = importlib.util.spec_from_file_location("ab_build", path)
        ab_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ab_build)
        symbol, argtypes = _build.SIGNATURES[name]
        assert ab_build.argtypes(_build.CSRC / f"{name}.cu",
                                 symbol) == argtypes

    def test_file_imports_neither_jax_nor_repro(self):
        src = pathlib.Path(__file__).resolve().parents[1] / "src"
        code = ("import sys; sys.path.insert(0, %r); import runpy; "
                "runpy.run_path(%r, run_name='mapping'); "
                "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
                "('jax', 'jaxlib', 'repro')); assert not bad, bad"
                % (str(src), __file__))
        env = dict(os.environ, PYTHONPATH=str(src))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr


# --------------------------------------------------------------- card --

def knn_case(dev, b, s, n, c, seed, grid=False):
    rng = np.random.default_rng(seed)
    pts = (grid_cloud(rng, b, n, c) if grid
           else rng.standard_normal((b, n, c)).astype(F32))
    pick = rng.integers(0, n, s)
    smp = pts[:, pick] + (0 if grid else
                          F32(0.01) * rng.standard_normal((b, s, c))
                          .astype(F32))
    return t(smp).to(dev), t(pts).to(dev)


def assert_knn_kernel(smp, pts, k, radius=None):
    before = knn_mod.knn_cuda.launches
    before_radius = knn_mod.knn_cuda.radius_launches
    got = knn_mod.knn(smp, pts, k, radius)
    torch.cuda.synchronize()
    assert knn_mod.knn_cuda.launches == before + 1
    assert knn_mod.knn_cuda.radius_launches == before_radius + (
        radius is not None)
    want = ref.knn_ref(smp, pts, k, radius)
    assert torch.equal(got, want), (got != want).nonzero()[:5]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s,n", LITE_KNN + ELITE_KNN)
def test_knn_stage_shapes_on_card(cuda_device, s, n):
    smp, pts = knn_case(cuda_device, 32, s, n, 3, seed=s + n)
    assert_knn_kernel(smp, pts, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 4842, 4843, 8192])
@pytest.mark.parametrize("c", [3, 5, 8])
@pytest.mark.parametrize("k", [1, 16, 24, 32, 48, "N"])
def test_knn_k_c_n_on_card(cuda_device, k, c, n):
    k = n if k == "N" else min(k, n)
    s = 8 if k > 64 else 40
    smp, pts = knn_case(cuda_device, 2, s, n, c, seed=k + c + n)
    assert_knn_kernel(smp, pts, k)


@pytest.mark.cuda
def test_knn_past_the_old_limit_on_card(cuda_device):
    smp, pts = knn_case(cuda_device, 2, 6000, 24000, 3, seed=24)
    assert_knn_kernel(smp, pts, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 8, 16, 40, 100])
def test_knn_float_maximum_and_ties_on_card(cuda_device, k):
    """Rows with fewer than k distances below FLT_MAX (the overwrite
    rule's re-picks), exactly FLT_MAX distances, and integer-grid ties."""
    n = 120
    rng = np.random.default_rng(k)
    big = F32(3e19)                       # its square overflows to inf
    # (x, y, 0) with x*x + y*y == FLT_MAX exactly in float32
    x_max, y_max = F32(1.8446743e19), F32(4.503599e15)
    assert x_max * x_max + y_max * y_max == FLT_MAX
    pts = grid_cloud(rng, 4, n, 3, span=2)
    kind = rng.integers(0, 3, (4, n))
    kind[2] = 2                           # a lane of inf distances only
    kind[3] = np.where(rng.random(n) < 0.2, 1, 2)   # maxima and inf
    for b in range(4):
        pts[b, kind[b] == 1] = (x_max, y_max, 0)
        pts[b, kind[b] == 2] = (big, 0, 0)
    smp = np.zeros((4, 6, 3), F32)        # at the origin: d = |p|^2
    smp_t, pts_t = t(smp).to(cuda_device), t(pts).to(cuda_device)
    d = ref.pairwise_sqdist(smp_t, pts_t)
    assert bool((d == float(FLT_MAX)).any()) and bool(torch.isinf(d).any())
    assert_knn_kernel(smp_t, pts_t, k)
    # integer grid, samples on grid points: exact ties and d = 0
    smp_t, pts_t = knn_case(cuda_device, 4, 50, n, 3, seed=k, grid=True)
    assert_knn_kernel(smp_t, pts_t, min(k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [0.1, 0.5, float("inf")])
@pytest.mark.parametrize("s,n,k", [
    *[(s, n, 16) for s, n in LITE_KNN + ELITE_KNN],
    *[(s, n, 1) for s, n in SEG_UPSAMPLE],
    (40, 4843, 16), (40, 1000, 48), (8, 2000, 2000)])
def test_knn_radius_on_card(cuda_device, radius, s, n, k):
    """The ball query's fill in both kernels (knn_kernel; past N = 1024
    or k = 32 the k-round kernel), bitwise against the plain version; at
    radius = inf the plain kNN indices."""
    smp, pts = knn_case(cuda_device, 32 if n <= 1024 else 2, s, n, 3,
                        seed=s + n + k)
    smp, pts = 0.5 * smp, 0.5 * pts              # radii of a few picks
    got = assert_knn_kernel(smp, pts, k, radius)
    plain = knn_mod.knn_cuda(smp, pts, k)
    if radius == float("inf"):
        assert torch.equal(got, plain)
    elif k > 1 and radius < 0.5:
        assert bool((got != plain).any()), "the radius filled no pick"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 8, 16, 40, 100])
def test_knn_radius_at_the_float_maximum_on_card(cuda_device, k):
    """Re-picks at FLT_MAX keep or fill by the re-picked point's own
    distance (the key of the pick that first chose it), in both
    kernels."""
    n = 120
    rng = np.random.default_rng(k + 1)
    x_max, y_max = F32(1.8446743e19), F32(4.503599e15)
    pts = grid_cloud(rng, 4, n, 3, span=2)
    kind = rng.integers(0, 3, (4, n))
    kind[3] = np.where(rng.random(n) < 0.9, 2, 0)   # few finite points
    for b in range(4):
        pts[b, kind[b] == 1] = (x_max, y_max, 0)
        pts[b, kind[b] == 2] = (F32(3e19), 0, 0)
    smp = np.zeros((4, 6, 3), F32)
    assert_knn_kernel(t(smp).to(cuda_device), t(pts).to(cuda_device), k,
                      radius=2.0)


def assert_fps_kernel(pts, s):
    before = fps_mod.fps_cuda.launches
    got = fps_mod.fps(pts, s)
    torch.cuda.synchronize()
    assert fps_mod.fps_cuda.launches == before + 1
    want = ref.fps_ref(pts, s)
    assert torch.equal(got, want), (got != want).nonzero()[:5]
    return got


def fps_cloud(dev, b, n, seed):
    pts = np.random.default_rng(seed).standard_normal((b, n, 3)).astype(F32)
    if b > 1:
        pts[0] = 0                                   # a padded lane
    if b > 2:
        pts[1, n // 2:] = pts[1, :n - n // 2]        # duplicates
    return t(pts).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", ELITE_FPS)
def test_fps_stage_shapes_on_card(cuda_device, n, s):
    got = assert_fps_kernel(fps_cloud(cuda_device, 32, n, n), s)
    assert (got[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(50, 1), (50, 50), (50, 17), (1, 1),
                                 (8192, 8), (8192, 8192), (8193, 8),
                                 (8193, 8193), (24000, 6000)])
def test_fps_any_n_on_card(cuda_device, n, s):
    assert_fps_kernel(fps_cloud(cuda_device, 3 if n > 1 else 1, n, n + s), s)


@pytest.mark.cuda
def test_fps_integer_grid_on_card(cuda_device):
    rng = np.random.default_rng(5)
    pts = t(grid_cloud(rng, 8, 1024, 3, span=4)).to(cuda_device)
    assert_fps_kernel(pts, 512)

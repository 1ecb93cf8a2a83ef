"""Parity of the port's training slice (``repro_torch.train``, ``data``, QAT) with ``repro``.

The same inputs, drawn with ``np.random.default_rng`` (parameters
included, with BN statistics and biases off their identity values), go
through the JAX package and the port on the CPU.  JAX trains on
``backend="ref"``, so no Pallas kernel is reached; the port's kNN and
FPS wrappers run their plain versions here.  Tolerances:

* fake-quant values and the int8 stochastic rounding: bitwise; the
  straight-through gradients equal ``jax.grad``'s (both the identity).
* ``batchnorm_update_stats``: rtol 1e-6, and 1e-6 of the leaf's largest
  value for a mean near zero (a mean of 1024 terms summed in another
  order).
* ``pointmlp_apply(train=True)`` at the JAX tests' ``tiny()`` size (128
  points, embed 16, k 8, B 4), Lite (URS, 8/8 fake quant) and Elite (FPS,
  learnable affine), both in float64 (parameters and clouds; the loss's
  softmax stays float32 in both packages, an error of ~1e-7 that the
  backward carries).  URS/FPS and kNN indices identical (checked stage by
  stage), the LFSR state identical, logits within 1e-9 of max|logit|,
  refreshed BN stats within 1e-9 of the leaf's max|stat|.  The
  comparison is made in float64 because QAT in float32 is not repeatable
  across two implementations: an activation an ulp from a rounding
  boundary takes another code (one step, 1/127 of the tensor's absmax),
  BN on batch statistics over the 32 rows of the last stage and the 4 of
  the head magnifies the step, and the codes after it scatter further;
  with some parameter draws the two packages' float32 logits end up
  ~10% apart.  In float64 no code differs (the test counts and prints
  the differing codes layer by layer, JAX's through
  ``jax.debug.callback`` inside its jitted gradient).  Gradients:

  - Elite: each leaf within 1e-6 of its max|g| plus 1e-8 of the tree's;
  - Lite: each leaf within 10% of its norm plus 1e-4 of the tree's norm,
    and the tree within 5%.  This bound is loose on purpose: Lite's
    gradients are not a function of its float64 inputs alone.  A
    max-pool sends a window's gradient to its largest value, or splits it
    evenly over a tie; fake quant makes exact ties common (two neighbours
    whose inputs round to the same codes give the same row), and
    identical rows can leave a GEMM an ulp apart, by their place in it.
    Whether a tie survives then depends on the GEMM's summation order,
    and the gradient goes to other points.  The test shows it on the
    port alone: the same step with each product summed in reverse order
    moves the gradient tree by about as much as JAX's differs (both are
    printed).  The forward is tight (logits and BN stats above, every
    code equal), the gradient machinery is held tightly on Elite, and
    the straight-through estimator is the identity (``TestQuant``).

* one trainer step (SGD then ``_merge_bn``): Lite's gradient bound
  times the learning rate.
* optimizers: rtol 1e-6 (SGD momentum, cosine, global-norm clip), 1e-5
  (AdamW: ``pow``, ``sqrt`` and divisions, each an ulp apart).
* checkpoints: exact, both ways between the packages.
* the data's geometry: ``shape_points`` on JAX's own uniform draws
  within 2e-6 of ``_shape_points`` (numpy's and XLA's trig differ by an
  ulp or two).

Tests marked ``cuda`` hold a training step on the card against the same
step on the CPU; they skip where no GPU is present.
"""
import contextlib
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from benchmarks._pointmlp_train import _merge_bn as jax_merge_bn
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import fusion as jfusion
from repro.core import knn as jknn
from repro.core import quant as jquant
from repro.core import sampling as jsampling
from repro.core.quant import QuantConfig as JaxQuantConfig
from repro.data import pointclouds as jdata
from repro.models import layers as JL
from repro.models import pointmlp as JPM
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.api import plan as tplan
from repro_torch.api import registry
from repro_torch.api.spec import elite_spec
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import from_numpy_tree
from repro_torch.core import fusion as tfusion
from repro_torch.core import knn as tknn
from repro_torch.core import quant as tquant
from repro_torch.core import sampling as tsampling
from repro_torch.core.quant import QuantConfig
from repro_torch.data import pointclouds as tdata
from repro_torch.models import layers as TL
from repro_torch.models import pointmlp as TPM
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import pointmlp as TP
from repro_torch.train import train_loop as tloop
from repro_torch.tree import leaves_with_paths, tree_map, tree_map_with_path

TINY = dict(n_points=128, embed_dim=16, k_neighbors=8)
B = 4
LFSR_SEED = 3
LR = 0.02
# Tolerances by run (see the module docstring): logits and BN stats
# relative to the largest value; gradients per leaf and over the tree.
TOL = {"lite": dict(logits=1e-9, bn=1e-9, leaf=1e-1, tree_floor=1e-4,
                    tree=5e-2),
       "elite": dict(logits=1e-9, bn=1e-9, leaf=1e-6, tree_floor=1e-8)}


@contextlib.contextmanager
def x64():
    """JAX in float64 within the block (the flag is restored after)."""
    saved = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def tiny(maker):
    return maker(8).replace(**TINY)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree):
    """{path: numpy leaf} of a JAX or port tree."""
    return {p: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for p, v in leaves_with_paths(tree)}


def act_codes(v):
    return np.clip(np.round(v), -128, 127)


def jax_train_step(cfg, params, pts, cls, lfsr, monkeypatch):
    """JAX's jitted loss and gradient (``benchmarks/_pointmlp_train.py``'s
    ``loss_fn``), with every fake-quant activation's ``x / scale``
    recorded in layer order."""
    log, order = {}, []
    orig = JL.fake_quant_act

    def record(x, q):
        i = len(order)
        order.append(i)
        s = jquant.compute_scale(x, q.a_bits, None)
        jax.debug.callback(lambda v, i=i: log.__setitem__(i, np.asarray(v)),
                           x / s)
        return orig(x, q)
    monkeypatch.setattr(JL, "fake_quant_act", record)

    def loss_fn(p, x, y, lf):
        logits, p_new, lf = JPM.pointmlp_apply(p, cfg, x, lf, train=True)
        return JL.softmax_cross_entropy(logits, y), (logits, p_new, lf)

    (loss, (logits, p_new, lf)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(pts),
        jnp.asarray(cls, jnp.int32), lfsr)
    monkeypatch.setattr(JL, "fake_quant_act", orig)
    return dict(loss=float(loss), logits=np.asarray(logits),
                p_new=np_tree(p_new), lfsr=np.asarray(lf),
                grads=np_tree(grads), codes=[log[i] for i in order])


def port_train_step(cfg, params, pts, cls, lfsr, monkeypatch):
    log = []
    orig = TL.fake_quant_act

    def record(x, q):
        log.append((x / tquant.compute_scale(x, q.a_bits)).detach().numpy())
        return orig(x, q)
    monkeypatch.setattr(TL, "fake_quant_act", record)
    loss, grads, p_new, lf = TP.loss_and_grads(
        from_numpy_tree(params), cfg, torch.from_numpy(pts),
        torch.from_numpy(cls), lfsr)
    logits, _, _ = TPM.pointmlp_apply(from_numpy_tree(params), cfg,
                                      torch.from_numpy(pts), lfsr,
                                      train=True)
    monkeypatch.setattr(TL, "fake_quant_act", orig)
    return dict(loss=float(loss), logits=logits.detach().numpy(),
                p_new=p_new, lfsr=lf.numpy(), grads=grads,
                codes=log[:len(log) // 2])


def mapping_matches(cfg, pts, lfsr_seed):
    """Each stage's sampled and kNN indices, JAX against the port."""
    j_state = jsampling.seed_streams(lfsr_seed, pts.shape[0])
    t_state = tsampling.seed_streams(lfsr_seed, pts.shape[0])
    j_cur, t_cur = jnp.asarray(pts), torch.from_numpy(pts)
    for n_samp in cfg.stage_samples:
        if cfg.sampler == "fps":
            j_idx = jsampling.fps_batched(j_cur, n_samp)
            t_idx = tsampling.fps(t_cur, n_samp)
        else:
            j_state, j_idx = jsampling.urs_indices_batched(
                j_state, j_cur.shape[1], n_samp, batch=pts.shape[0])
            t_state, t_idx = tsampling.urs_indices_batched(
                t_state, t_cur.shape[1], n_samp, batch=pts.shape[0])
        np.testing.assert_array_equal(np.asarray(j_idx), t_idx.numpy())
        j_new = jnp.take_along_axis(j_cur, j_idx[..., None], axis=1)
        t_new = tsampling.gather_points(t_cur, t_idx)
        np.testing.assert_array_equal(
            np.asarray(jknn.knn_batched(j_new, j_cur, cfg.k_neighbors)),
            tknn.knn_batched(t_new, t_cur, cfg.k_neighbors).numpy())
        j_cur, t_cur = j_new, t_new


def tree_rel(want, got):
    """||got - want|| / ||want|| over a whole gradient tree."""
    want, got = flat(want), flat(got)
    return np.sqrt(sum(np.sum((want[k] - got[k]) ** 2) for k in want)
                   / sum(np.sum(v ** 2) for v in want.values()))


def grad_close(want, got, tol):
    """Hold each gradient leaf to ``tol`` (a ``TOL`` entry); return the
    worst ratio of error to allowance.  A float32 entry (with ``tree``)
    holds norms, per leaf and over the tree; a float64 one elements."""
    want, got = flat(want), flat(got)
    assert set(want) == set(got)
    worst = 0.0
    if "tree" in tol:
        norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                           for v in want.values()))
        err_all = np.sqrt(sum(np.sum((want[k] - got[k]).astype(np.float64)
                                     ** 2) for k in want))
        assert err_all <= tol["tree"] * norm, (err_all, norm)
        for path, w in want.items():
            allowed = tol["leaf"] * np.linalg.norm(w) + \
                tol["tree_floor"] * norm
            err = np.linalg.norm(w - got[path])
            assert err <= allowed, (path, err, allowed)
            worst = max(worst, err / allowed)
        return worst
    g_max = max(np.abs(v).max() for v in want.values())
    for path, w in want.items():
        allowed = tol["leaf"] * np.abs(w).max() + tol["tree_floor"] * g_max
        err = np.abs(w - got[path]).max()
        assert err <= allowed, (path, err, allowed)
        worst = max(worst, err / allowed)
    return worst


def draw_params(cfg, rng):
    """A float64 parameter tree of ``cfg``'s structure (JAX's and the
    port's) drawn from ``rng``: weights N(0, 1/c_in) as the inits draw
    them, and biases, BN statistics and the affine alpha/beta off their
    identity values, so every term of the walk is exercised."""
    def draw(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        if name == "w":
            return rng.standard_normal(shape) / np.sqrt(shape[0])
        if name in ("gamma", "alpha"):
            return rng.uniform(0.7, 1.3, shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.standard_normal(shape)      # b, beta, mean
    return tree_map_with_path(draw, TPM.pointmlp_init(
        cfg, torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def runs():
    """JAX's and the port's float64 training forward and gradient on Lite
    (QAT) and Elite, once each, shared by the tests."""
    out = {}
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as mp:
        for name, j_maker, t_maker in (
                ("lite", JPM.pointmlp_lite_config, TPM.pointmlp_lite_config),
                ("elite", JPM.pointmlp_elite_config,
                 TPM.pointmlp_elite_config)):
            j_cfg, t_cfg = tiny(j_maker), tiny(t_maker)
            params = draw_params(t_cfg, rng)
            pts = rng.standard_normal((B, TINY["n_points"], 3))
            cls = rng.integers(0, 8, B)
            with x64():
                j_run = jax_train_step(j_cfg, params, pts, cls,
                                       jsampling.seed_streams(LFSR_SEED, B),
                                       mp)
            out[name] = dict(
                j_cfg=j_cfg, t_cfg=t_cfg, params=params, pts=pts, cls=cls,
                jax=j_run,
                port=port_train_step(t_cfg, params, pts, cls,
                                     tsampling.seed_streams(LFSR_SEED, B),
                                     mp))
    return out


# ------------------------------------------------------- small pieces --

class TestQuant:
    @pytest.mark.parametrize("bits,axis", [(8, None), (4, None), (8, 0),
                                           (6, 1)])
    def test_fake_quant_bitwise_with_identity_gradient(self, bits, axis):
        rng = np.random.default_rng(bits)
        x = rng.standard_normal((6, 40)).astype(np.float32)
        r = rng.standard_normal((6, 40)).astype(np.float32)
        jv, jg = jax.value_and_grad(
            lambda a: jnp.sum(jquant.fake_quant(a, bits, axis) * r))(
            jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        tv = tquant.fake_quant(tx, bits, axis)
        tg, = torch.autograd.grad((tv * torch.from_numpy(r)).sum(), tx)
        np.testing.assert_array_equal(
            np.asarray(jquant.fake_quant(jnp.asarray(x), bits, axis)),
            tv.detach().numpy())
        np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
        np.testing.assert_array_equal(tg.numpy(), r)

    @pytest.mark.parametrize("per_channel", [True, False])
    def test_fake_quant_weight_and_act(self, per_channel):
        rng = np.random.default_rng(5)
        w = rng.standard_normal((3, 24, 16)).astype(np.float32)
        x = (rng.standard_normal((2, 9, 24)) * [[[1.0]], [[7.0]]]
             ).astype(np.float32)
        jq = JaxQuantConfig(w_bits=8, a_bits=8, per_channel=per_channel)
        tq = QuantConfig(w_bits=8, a_bits=8, per_channel=per_channel,
                         backend="fake")
        np.testing.assert_array_equal(
            np.asarray(jquant.fake_quant_weight(jnp.asarray(w), jq)),
            tquant.fake_quant_weight(torch.from_numpy(w), tq).numpy())
        np.testing.assert_array_equal(
            np.asarray(jquant.fake_quant_act(jnp.asarray(x), jq)),
            tquant.fake_quant_act(torch.from_numpy(x), tq).numpy())
        tw = torch.from_numpy(w).requires_grad_(True)
        g, = torch.autograd.grad(tquant.fake_quant_weight(tw, tq).sum(), tw)
        assert torch.equal(g, torch.ones_like(g))
        assert tquant.fake_quant_weight(tw, QuantConfig(32, 32)) is tw

    def test_qat_activation_scale_spans_the_batch(self):
        """Hazard: the QAT matmul's activation scale is one absmax over the
        whole batch tensor (not per lane, as serving's W8A8 is)."""
        rng = np.random.default_rng(6)
        x = (rng.standard_normal((2, 5, 12)) * [[[0.01]], [[3.0]]]
             ).astype(np.float32)
        w = rng.standard_normal((12, 7)).astype(np.float32)
        q = QuantConfig(w_bits=8, a_bits=8)
        got = TL._matmul(torch.from_numpy(x), torch.from_numpy(w), q)
        want = JL._matmul(jnp.asarray(x), jnp.asarray(w),
                          JaxQuantConfig(w_bits=8, a_bits=8))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        # the quiet lane's values all fall under one step of the loud
        # lane's scale, so they quantize to zero
        assert torch.all(got[0] == 0)

    def test_stochastic_round_int8_exact(self):
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((64, 33)) * 40).astype(np.float32)
        bits = rng.integers(0, 2 ** 32, (64, 33), dtype=np.uint64)
        scale = np.float32(0.37)
        want = jquant.stochastic_round_int8(
            jnp.asarray(x), jnp.asarray(scale),
            jnp.asarray(bits.astype(np.uint32)))
        got = tquant.stochastic_round_int8(
            torch.from_numpy(x), torch.tensor(scale),
            torch.from_numpy(bits.astype(np.int64)))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(want), got.numpy())

    def test_dequantize_tree_round_trip(self):
        rng = np.random.default_rng(13)
        params = {"embed": {"w": rng.standard_normal((3, 16)),
                            "b": rng.standard_normal(16)},
                  "stages": [{"w": rng.standard_normal((2, 16, 8)),
                              "bn": {"mean": rng.standard_normal(8)}}]}
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                        params)
        q = QuantConfig(w_bits=8, a_bits=8)
        exported = tquant.quantize_tree(from_numpy_tree(params), q)
        back = tquant.dequantize_tree(exported)
        j_back = jquant.dequantize_tree(jquant.quantize_tree(
            jax.tree_util.tree_map(jnp.asarray, params),
            JaxQuantConfig(w_bits=8, a_bits=8)))
        want, got, orig = flat(j_back), flat(back), flat(params)
        assert set(got) == set(orig)
        for path, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(want[path]))
            if path[-1] == "w":
                step = np.abs(orig[path]).max(axis=-2, keepdims=True) / 127
                assert np.all(np.abs(v - orig[path]) <= step / 2 + 1e-7)
            else:
                np.testing.assert_array_equal(v, orig[path])


class TestBatchNorm:
    def test_update_stats_matches_jax(self):
        rng = np.random.default_rng(8)
        x = (rng.standard_normal((4, 32, 8, 24)) * 3 + 1).astype(np.float32)
        bn = {"gamma": rng.uniform(0.5, 1.5, 24).astype(np.float32),
              "beta": rng.standard_normal(24).astype(np.float32),
              "mean": rng.standard_normal(24).astype(np.float32),
              "var": rng.uniform(0.5, 2, 24).astype(np.float32)}
        want = jfusion.batchnorm_update_stats(
            jax.tree_util.tree_map(jnp.asarray, bn), jnp.asarray(x), 0.9)
        got = tfusion.batchnorm_update_stats(from_numpy_tree(bn),
                                             torch.from_numpy(x), 0.9)
        for k in bn:
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
        init = tfusion.batchnorm_init(5)
        for k, v in jfusion.batchnorm_init(5).items():
            np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))

    def test_population_variance_and_momentum_convention(self):
        """Hazard: population variance, and ``m * old + (1 - m) * new``
        with m = 0.9 (torch's BatchNorm weighs the new value by its
        momentum and keeps an unbiased running variance)."""
        x = torch.tensor([[1.0], [3.0]])
        mu, var = tfusion.batch_moments(x)
        assert float(mu) == 2.0 and float(var) == 1.0       # not 2.0
        bn = tfusion.batchnorm_init(1)
        new = tfusion.batchnorm_update_stats(bn, x, momentum=0.9)
        assert torch.allclose(new["mean"], torch.tensor([0.2]))
        assert torch.allclose(new["var"], torch.tensor([1.0]))
        rm, rv = torch.zeros(1), torch.ones(1)
        torch.nn.functional.batch_norm(x, rm, rv, training=True,
                                       momentum=0.9)
        assert not torch.allclose(rm, new["mean"])
        assert not torch.allclose(rv, new["var"])


class TestHazards:
    def test_amax_splits_a_tied_gradient_as_reduce_max(self):
        x = np.array([[1.0, 3.0, 3.0, -2.0], [0.0, 0.0, 0.0, 0.0]],
                     np.float32)
        jg = jax.grad(lambda a: jnp.sum(jnp.max(a, axis=1) * jnp.array(
            [1.0, 2.0])))(jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        tg, = torch.autograd.grad((tx.amax(dim=1) * torch.tensor(
            [1.0, 2.0])).sum(), tx)
        np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
        assert float(tg[0, 1]) == 0.5

    def test_sigma_gradient_matches_jax(self):
        rng = np.random.default_rng(9)
        off = rng.standard_normal((2, 6, 4, 5)).astype(np.float32)
        jg = jax.grad(lambda o: jnp.sqrt(jnp.mean(o * o) + 1e-5))(
            jnp.asarray(off))
        to = torch.from_numpy(off).requires_grad_(True)
        tg, = torch.autograd.grad(tknn.group_sigma(to), to)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-9)

    def test_fused_group_refuses_training(self, runs):
        cfg = tiny(TPM.pointmlp_elite_config)
        spec = elite_spec(8, **TINY).replace(fused_group="grouped_transfer")
        plan = tplan.lower(spec, cfg.replace(use_bn=False))
        sampler, grouper, _ = registry.resolve("fps", "knn", "ref")
        params = from_numpy_tree(runs["elite"]["params"])
        with pytest.raises(ValueError, match="inference-only"):
            TPM._forward_impl(params, cfg,
                              torch.from_numpy(runs["elite"]["pts"]), None,
                              sampler=sampler, grouper=grouper, plan=plan,
                              train=True)

    def test_softmax_cross_entropy(self):
        rng = np.random.default_rng(10)
        logits = (rng.standard_normal((6, 40)) * 4).astype(np.float32)
        labels = rng.integers(0, 40, 6)
        jv, jg = jax.value_and_grad(JL.softmax_cross_entropy)(
            jnp.asarray(logits), jnp.asarray(labels, jnp.int32))
        tl = torch.from_numpy(logits).requires_grad_(True)
        tv = TL.softmax_cross_entropy(tl, torch.from_numpy(labels))
        tg, = torch.autograd.grad(tv, tl)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-7)


# ------------------------------------------- the training forward --

@pytest.mark.parametrize("name", ["lite", "elite"])
class TestTrainForward:
    def test_mapping_identical(self, runs, name):
        r = runs[name]
        with x64():
            mapping_matches(r["t_cfg"], r["pts"], LFSR_SEED)

    def test_logits_loss_and_lfsr(self, runs, name):
        j, t = runs[name]["jax"], runs[name]["port"]
        assert t["logits"].dtype == j["logits"].dtype
        scale = np.abs(j["logits"]).max()
        np.testing.assert_allclose(t["logits"], j["logits"], rtol=0,
                                   atol=TOL[name]["logits"] * scale)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-6)
        np.testing.assert_array_equal(t["lfsr"], j["lfsr"])

    def test_refreshed_bn_stats(self, runs, name):
        j, t = flat(runs[name]["jax"]["p_new"]), flat(
            runs[name]["port"]["p_new"])
        assert set(j) == set(t)
        moved = 0
        for path, w in j.items():
            if path[-2:-1] == ("bn",) and path[-1] in ("mean", "var"):
                np.testing.assert_allclose(
                    t[path], w, rtol=0,
                    atol=TOL[name]["bn"] * np.abs(w).max(),
                    err_msg=str(path))
                moved += 1
            else:            # everything else passes through unchanged
                np.testing.assert_array_equal(t[path], w)
        assert moved == 2 * 27              # 25 convs, fc1 and fc2

    def test_gradients(self, runs, name, monkeypatch):
        r = runs[name]
        worst = grad_close(r["jax"]["grads"], r["port"]["grads"], TOL[name])
        print(f"{name}: worst gradient error {worst:.3f} of its allowance; "
              f"tree {tree_rel(r['jax']['grads'], r['port']['grads']):.2e}"
              f" off JAX's")
        if name == "lite":
            # the port against itself, each product summed in reverse
            monkeypatch.setattr(TL, "matmul", lambda x, w: torch.einsum(
                "...k,kn->...n", x.flip(-1), w.flip(0)))
            _, grads, _, _ = TP.loss_and_grads(
                from_numpy_tree(r["params"]), r["t_cfg"],
                torch.from_numpy(r["pts"]), torch.from_numpy(r["cls"]),
                tsampling.seed_streams(LFSR_SEED, B))
            print(f"lite: tree {tree_rel(r['port']['grads'], grads):.2e} "
                  f"off the port's own, its sums reversed")
        if name == "elite":
            g = flat(runs[name]["port"]["grads"])
            for s in range(4):
                assert np.abs(g[("stages", s, "affine", "alpha")]).max() > 0

    def test_fake_quant_codes_reported(self, runs, name):
        j, t = runs[name]["jax"]["codes"], runs[name]["port"]["codes"]
        if name == "elite":
            assert j == [] and t == []
            return
        assert len(j) == len(t) == 28        # 27 CBR layers and fc3
        assert j[0].dtype == np.float64
        per_layer = [int((act_codes(a) != act_codes(b)).sum())
                     for a, b in zip(j, t)]
        n = sum(a.size for a in j)
        print(f"lite: {sum(per_layer)} of {n} fake-quant activation codes "
              f"differ between JAX and the port (by layer: {per_layer})")
        for a, b in zip(j, t):
            assert a.shape == b.shape
            assert np.abs(act_codes(a) - act_codes(b)).max() <= 1


def test_eval_mode_matches_jax(runs):
    """``pointmlp_apply(train=False)``: BN on its running stats, the
    fake-quant matmuls of ``lower_config``, per-cloud URS."""
    r = runs["lite"]
    params = r["jax"]["p_new"]
    with x64():
        want, _, j_state = jax.jit(JPM.pointmlp_apply, static_argnums=1)(
            jax.tree_util.tree_map(jnp.asarray, params), r["j_cfg"],
            jnp.asarray(r["pts"]), jsampling.seed_streams(LFSR_SEED, B))
    tp = from_numpy_tree(params)
    got, same, t_state = TPM.pointmlp_apply(
        tp, r["t_cfg"], torch.from_numpy(r["pts"]),
        tsampling.seed_streams(LFSR_SEED, B))
    assert same is tp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["lite"]["logits"]
                               * np.abs(want).max())
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))


def test_trainer_step_matches_jax(runs):
    """One step of ``benchmarks/_pointmlp_train.py``: SGD then
    ``_merge_bn`` (which keeps BN's gamma and beta as they were)."""
    r = runs["lite"]
    j = r["jax"]
    want = jax_merge_bn(jax.tree_util.tree_map(
        lambda a, b: a - np.float32(LR) * b, r["params"], j["grads"]),
        j["p_new"])
    _, got, lf = TP.sgd_step(from_numpy_tree(r["params"]), r["t_cfg"],
                             torch.from_numpy(r["pts"]),
                             torch.from_numpy(r["cls"]),
                             tsampling.seed_streams(LFSR_SEED, B),
                             TP.cosine(LR, 0, 10))
    np.testing.assert_array_equal(lf.numpy(), j["lfsr"])
    want_f, got_f, g = flat(want), flat(got), flat(j["grads"])
    tol = TOL["lite"]
    norm = np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                       for v in g.values()))
    for path, w in want_f.items():
        if path[-2:-1] == ("bn",):
            if path[-1] in ("gamma", "beta"):
                np.testing.assert_array_equal(got_f[path],
                                              flat(r["params"])[path])
            np.testing.assert_allclose(got_f[path], w, rtol=0,
                                       atol=tol["bn"] * np.abs(w).max())
            continue
        allowed = LR * (tol["leaf"] * np.linalg.norm(g[path])
                        + tol["tree_floor"] * norm)
        # the step's own rounding: half an ulp of the params' scale
        allowed += 1e-7 * np.linalg.norm(w)
        assert np.linalg.norm(got_f[path] - w) <= allowed, path


def test_training_reduces_eval_loss():
    """Tiny Lite with 8/8 fake quant, 24 steps of the trainer cycling two
    fixed batches, as ``tests/test_pointmlp_system.py``'s
    ``test_training_reduces_loss``: the loss on those batches drops."""
    cfg = tiny(TPM.pointmlp_lite_config)
    params = TPM.pointmlp_init(cfg, torch.Generator().manual_seed(0))
    batches = [tdata.make_batch(0, s, cfg.n_points, 16, "cpu")
               for s in range(2)]
    eval_pts = torch.cat([b[0] for b in batches])
    eval_cls = torch.cat([b[1] for b in batches])

    def eval_loss(p):
        logits, _, _ = TPM.pointmlp_apply(p, cfg, eval_pts,
                                          tsampling.seed_streams(1, 32))
        return float(TL.softmax_cross_entropy(logits, eval_cls))

    before = eval_loss(params)
    lfsr = tsampling.seed_streams(0, 16)
    for s in range(24):
        pts, cls = batches[s % 2]
        _, params, lfsr = TP.sgd_step(params, cfg, pts, cls, lfsr, LR)
    after = eval_loss(params)
    assert after < before - 0.05, (before, after)


# --------------------------------------------------------- optimizer --

@pytest.fixture(scope="module")
def opt_trees():
    rng = np.random.default_rng(11)
    p = {"a": rng.standard_normal((5, 3)).astype(np.float32),
         "b": [rng.standard_normal(4).astype(np.float32),
               {"c": rng.standard_normal((2, 2)).astype(np.float32)}]}
    gs = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
        for _ in range(3)]
    return p, gs


def assert_tree_close(got, want, rtol, atol=0.0):
    want, got = flat(want), flat(got)
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=str(k))


class TestOptimizer:
    @pytest.mark.parametrize("kind", ["sgd", "adamw"])
    def test_updates_match_jax(self, opt_trees, kind):
        p, gs = opt_trees
        jc, tc = JaxTrainConfig(optimizer=kind), TrainConfig(optimizer=kind)
        j_init, j_upd = jopt.get_optimizer(jc)
        t_init, t_upd = topt.get_optimizer(tc)
        jp, tp = jax.tree_util.tree_map(jnp.asarray, p), from_numpy_tree(p)
        js, ts = j_init(jp), t_init(tp)
        for step, g in enumerate(gs):
            jlr = jopt.cosine_lr(jnp.asarray(step, jnp.int32), jc)
            tlr = topt.cosine_lr(step, tc)
            jp, js = j_upd(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           jlr, jc)
            tp, ts = t_upd(from_numpy_tree(g), ts, tp, tlr, tc)
        rtol = 1e-6 if kind == "sgd" else 1e-5
        assert_tree_close(tp, jp, rtol, atol=1e-7)
        assert_tree_close(ts, js, rtol, atol=1e-7)

    def test_train_config_is_jax(self):
        assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
            JaxTrainConfig())

    def test_cosine_endpoints(self):
        tc, jc = TrainConfig(steps=100), JaxTrainConfig(steps=100)
        for step in (0, 37, 100, 250):
            np.testing.assert_allclose(
                float(topt.cosine_lr(step, tc)),
                float(jopt.cosine_lr(jnp.asarray(step), jc)), rtol=1e-6)
        assert math.isclose(float(topt.cosine_lr(0, tc)), 0.1, rel_tol=1e-6)
        assert math.isclose(float(topt.cosine_lr(100, tc)), 0.005,
                            rel_tol=1e-6)

    @pytest.mark.parametrize("max_norm", [0.5, 100.0])
    def test_clip_by_global_norm(self, opt_trees, max_norm):
        _, gs = opt_trees
        jg, jn = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, gs[0]), max_norm)
        tg, tn = topt.clip_by_global_norm(from_numpy_tree(gs[0]), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert_tree_close(tg, jg, 1e-6)
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   min(max_norm, float(tn)), rtol=1e-5)


# ------------------------------------------------------- checkpoints --

class TestCheckpoint:
    def test_round_trip_and_atomic_manifest(self, runs, tmp_path):
        tree = from_numpy_tree(runs["lite"]["params"])
        d = tckpt.save(str(tmp_path), 7, tree, extra={"step": 7})
        assert sorted(f.name for f in d.iterdir()) == [
            "manifest.json", "shards_host0.npz"]
        manifest = json.loads((d / "manifest.json").read_text())
        assert manifest["step"] == 7 and manifest["extra"] == {"step": 7}
        assert manifest["leaves"]["stages/0/pre/0/net1/w"] == {
            "shape": [32, 8], "dtype": "float64"}
        # a save that died before its manifest was published is ignored
        (tmp_path / "step_00000009").mkdir()
        assert tckpt.latest_step(str(tmp_path)) == 7
        assert tckpt.latest_step(str(tmp_path / "none")) is None
        back, extra = tckpt.restore(str(tmp_path), 7, tree)
        assert extra == {"step": 7}
        for path, v in leaves_with_paths(tree):
            assert torch.equal(dict(leaves_with_paths(back))[path], v)

    def test_async_save_keeps_the_newest(self, tmp_path):
        saver = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
        tree = {"w": torch.zeros(3), "s": [torch.ones(2, dtype=torch.int32)]}
        for step in (1, 2, 3, 4):
            saver.save(step, tree, extra={"step": step})
            tree = tree_map(lambda x: x + 1, tree)   # after the copy
        saver.wait()
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "step_00000003", "step_00000004"]
        back, _ = tckpt.restore(str(tmp_path), 4, tree)
        assert torch.equal(back["w"], torch.full((3,), 3.0))
        assert back["s"][0].dtype == torch.int32

    def test_packages_restore_each_other(self, runs, tmp_path):
        params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                        runs["lite"]["params"])
        opt = {"m": params, "v": params, "count": np.int32(3)}
        jckpt.save(str(tmp_path / "jax"), 5, jax.tree_util.tree_map(
            jnp.asarray, opt), extra={"step": 5})
        tree = from_numpy_tree(opt)
        back, extra = tckpt.restore(str(tmp_path / "jax"), 5, tree)
        assert extra == {"step": 5}
        for path, v in leaves_with_paths(tree):
            assert torch.equal(dict(leaves_with_paths(back))[path], v)
        tckpt.save(str(tmp_path / "port"), 6, tree, extra={"step": 6})
        assert jckpt.latest_step(str(tmp_path / "port")) == 6
        j_back, extra = jckpt.restore(str(tmp_path / "port"), 6,
                                      jax.tree_util.tree_map(jnp.asarray,
                                                             opt))
        assert extra == {"step": 6}
        for path, v in flat(j_back).items():
            np.testing.assert_array_equal(v, flat(opt)[path])

    def test_resume_is_bit_exact(self, tmp_path):
        """Six trainer steps straight, against three, a checkpoint,
        a restore into fresh params and three more."""
        cfg = tiny(TPM.pointmlp_lite_config)
        init = TPM.pointmlp_init(cfg, torch.Generator().manual_seed(1))

        def run(params, lfsr, steps):
            for s in steps:
                pts, cls = tdata.make_batch(2, s, cfg.n_points, 4, "cpu")
                _, params, lfsr = TP.sgd_step(params, cfg, pts, cls, lfsr,
                                              TP.cosine(LR, s, 6))
            return params, lfsr

        straight, _ = run(init, tsampling.seed_streams(0, 4), range(6))
        half, lfsr = run(init, tsampling.seed_streams(0, 4), range(3))
        tckpt.save(str(tmp_path), 3, {"params": half, "lfsr": lfsr})
        fresh = TPM.pointmlp_init(cfg, torch.Generator().manual_seed(9))
        back, _ = tckpt.restore(str(tmp_path), 3,
                                {"params": fresh, "lfsr": lfsr})
        resumed, _ = run(back["params"], back["lfsr"], range(3, 6))
        for (path, a), (_, b) in zip(leaves_with_paths(straight),
                                     leaves_with_paths(resumed)):
            assert torch.equal(a, b), path


# --------------------------------------------------------- the loop --

def test_straggler_monitor_flags_as_jax():
    times = [0.1] * 12 + [0.35, 0.1, 0.19, 0.21, 0.1] + [0.5] * 40 + [1.2]
    j, t = jloop.StragglerMonitor(window=20), tloop.StragglerMonitor(
        window=20)
    assert [j.record(i, x) for i, x in enumerate(times)] == \
        [t.record(i, x) for i, x in enumerate(times)]
    assert t.flagged == j.flagged and len(t.flagged) >= 2


class ToyAPI:
    """Linear regression: enough of a model API for ``fit``."""

    def init(self, generator, device=None):
        return {"w": torch.randn(4, 2, generator=generator).to(device),
                "b": torch.zeros(2, device=device)}

    def loss_fn(self, params, batch):
        err = batch["x"] @ params["w"] + params["b"] - batch["y"]
        loss = (err * err).mean()
        return loss, {"loss": loss}


def toy_data(start_step):
    step = start_step
    while True:
        g = torch.Generator().manual_seed(1000 + step)
        x = torch.randn(8, 4, generator=g)
        yield {"x": x, "y": x[:, :2] * 2 - x[:, 2:]}
        step += 1


@pytest.mark.parametrize("kind,microbatch", [("sgd", 0), ("adamw", 2)])
def test_fit_resumes_bit_exact(tmp_path, kind, microbatch, capsys):
    """``fit`` straight through, against a run that dies after step 5
    (its last checkpoint is at 3) and a second ``fit`` that resumes."""
    base = TrainConfig(optimizer=kind, steps=8, batch_size=8,
                       microbatch=microbatch, checkpoint_every=3, lr=0.05)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = tloop.fit(ToyAPI(), dataclasses.replace(
        base, checkpoint_dir=a), toy_data, log_every=1, device="cpu")

    def die(step, params, metrics):
        if step == 5:
            for _ in range(500):          # the step-3 save is in flight
                if tckpt.latest_step(b + "/opt") == 3:
                    break
                time.sleep(0.01)
            raise KeyboardInterrupt("preempted")
    with pytest.raises(KeyboardInterrupt):
        tloop.fit(ToyAPI(), dataclasses.replace(base, checkpoint_dir=b),
                  toy_data, hooks={"on_step": die}, device="cpu")
    assert tckpt.latest_step(b) == 3
    resumed = tloop.fit(ToyAPI(), dataclasses.replace(
        base, checkpoint_dir=b), toy_data, log_every=1, device="cpu")
    for k in ("w", "b"):
        assert torch.equal(straight["params"][k], resumed["params"][k])
    assert resumed["history"][0]["step"] == 3
    assert straight["history"][-1]["loss"] < straight["history"][0]["loss"]
    assert tckpt.latest_step(b) == 6
    capsys.readouterr()


# -------------------------------------------------------------- data --

class TestData:
    def test_geometry_matches_jax_on_its_draws(self):
        key = jax.random.PRNGKey(4)
        k1, k2, k3 = jax.random.split(key, 3)
        n = 300
        u = np.asarray(jax.random.uniform(k1, (n,), minval=0.0, maxval=1.0))
        v = np.asarray(jax.random.uniform(k2, (n,), minval=0.0, maxval=1.0))
        w = np.asarray(jax.random.uniform(k3, (n,)))
        shapes = jax.jit(jdata._shape_points, static_argnums=2)
        for cls in range(tdata.N_CLASSES):
            want = np.asarray(shapes(key, cls, n))
            got = tdata.shape_points(cls, u, v, w)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6,
                                       err_msg=tdata.CLASS_NAMES[cls])
        assert tdata.CLASS_NAMES == jdata.CLASS_NAMES
        with pytest.raises(ValueError):
            tdata.shape_points(8, u, v, w)

    def test_batches_normalized_and_deterministic(self):
        pts, cls = tdata.make_batch(3, 5, 256, 16, "cpu")
        assert pts.shape == (16, 256, 3) and pts.dtype == torch.float32
        assert cls.dtype == torch.int64
        assert int(cls.min()) >= 0 and int(cls.max()) < tdata.N_CLASSES
        norms = pts.norm(dim=-1).amax(dim=1)
        assert torch.all((norms > 0.999) & (norms <= 1.0))
        assert float(pts.mean(dim=1).abs().max()) < 1e-5
        again, cls2 = tdata.make_batch(3, 5, 256, 16, "cpu")
        assert torch.equal(pts, again) and torch.equal(cls, cls2)
        other, _ = tdata.make_batch(3, 6, 256, 16, "cpu")
        assert not torch.equal(pts, other)
        it = tdata.dataset(3, 256, 16, start_step=5, device="cpu")
        assert torch.equal(next(it)[0], pts)
        assert torch.equal(next(it)[0], other)
        ev = tdata.eval_set(3, 256, 2, 16, "cpu")
        assert len(ev) == 2 and not torch.equal(ev[0][0], pts)

    def test_disk_and_sphere_told_apart(self):
        """The disk is flat (one principal axis ~0.05 of the others); the
        sphere is not."""
        rng = np.random.default_rng(12)
        u, v, w = rng.random((3, 2000), np.float32)

        def flatness(pts):
            ev = np.linalg.eigvalsh(np.cov(pts.T))
            return ev[0] / ev[-1]
        assert flatness(tdata.shape_points(6, u, v, w)) < 0.01
        assert flatness(tdata.shape_points(0, u, v, w)) > 0.5

    def test_stream_drifts(self):
        seq, cls = tdata.make_stream(1, 128, 5, drift=0.02, device="cpu")
        assert seq.shape == (5, 128, 3) and 0 <= cls < tdata.N_CLASSES
        step = (seq[1:] - seq[:-1]).norm(dim=-1).amax(dim=1)
        assert torch.all(step < 0.1) and torch.all(step > 0)


# ------------------------------------------------------------ on card --

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lite", "elite"])
def test_card_training_step_matches_cpu(runs, name, monkeypatch):
    """A float32 training step on the card against the CPU, from the same
    params, batch and LFSR state: the kNN (and FPS) kernels launch 4 times
    each; the loss within 1e-5; the gradients within Lite's bound against
    JAX (the same max-pool routing applies, and gather's backward sums
    with atomics on the card).  The CPU replays the card's fake-quant
    activations: in float32 one code a step apart cascades through the
    layers (``scripts/train_rounding.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import fps, knn
    r = runs[name]
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                    r["params"])
    orig, quantized = TL.fake_quant_act, []

    def record(x, q):
        y = orig(x, q)
        quantized.append(y.detach())
        return y

    def replay(x, q, it=iter(quantized)):
        return x + (next(it).to(x.device) - x).detach()

    out = {}
    for dev, tap in (("cuda", record), ("cpu", replay)):
        monkeypatch.setattr(TL, "fake_quant_act", tap)
        knn.knn_cuda.launches = fps.fps_cuda.launches = 0
        loss, grads, _, _ = TP.loss_and_grads(
            from_numpy_tree(params, dev), r["t_cfg"],
            torch.from_numpy(r["pts"].astype(np.float32)).to(dev),
            torch.from_numpy(r["cls"]).to(dev),
            tsampling.seed_streams(LFSR_SEED, B))
        out[dev] = (float(loss), tree_map(lambda x: x.cpu(), grads))
        if dev == "cuda":
            assert knn.knn_cuda.launches == 4
            assert fps.fps_cuda.launches == (4 if name == "elite" else 0)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    grad_close(out["cpu"][1], out["cuda"][1], TOL["lite"])

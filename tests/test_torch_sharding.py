"""Parity of the port's sharding rules and dry-run trees with ``repro``.

``repro_torch.sharding.rules`` against ``repro.sharding.rules``: the
cases of ``tests/test_sharding_rules.py`` re-asserted on the port, then
every full-size arch's operands on both production meshes, leaf for
leaf.  JAX's trees come from ``repro.launch.steps.shape_trees``
(``ShapeDtypeStruct``s), the port's from ``repro_torch.launch.steps.
shape_trees`` (fake tensors); paths are matched as key tuples (a JAX
``DictKey``'s key, a ``SequenceKey``'s index), specs compared as tuples
padded with None to the leaf's ndim, and per-device argument bytes held
to the sum of JAX's ``NamedSharding(AbstractMesh(...), spec).
shard_shape`` bytes.  Everything is shapes: exact equality throughout.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.configs import LM_SHAPES as JLM
from repro.configs import get_config as jax_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.quant import QuantConfig as JaxQuantConfig
from repro.launch import steps as JS
from repro.models.api import get_model as jax_get_model
from repro.sharding import rules as jrules
from repro_torch.configs import LM_SHAPES, get_config, list_archs
from repro_torch.configs.base import TrainConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import (Mesh, batch_axes, make_host_mesh,
                                     make_production_mesh, model_axis)
from repro_torch.models.api import get_model
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.tree import leaves_with_paths

MESH = make_production_mesh()
MP = make_production_mesh(multi_pod=True)
MESHES = {"pod": (MESH, AbstractMesh((16, 16), ("data", "model"))),
          "multipod": (MP, AbstractMesh((2, 16, 16),
                                        ("pod", "data", "model")))}
PROFILES = ("default", "replicated", "fsdp", "infer2d", "cache_seq",
            "moe_local")
TC = TrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)
JTC = JaxTrainConfig(optimizer="adamw", lr=3e-4, lr_min=3e-5)
W8 = QuantConfig(w_bits=8, a_bits=16, backend="int8_ref")
JW8 = JaxQuantConfig(w_bits=8, a_bits=16, backend="int8_ref")


def spec(path_names, shape, mesh=MESH, profile="default"):
    return rules.param_pspec(tuple(path_names), shape, mesh, profile)


# --------------------------------------------- test_sharding_rules.py --

class TestParamRules:
    def test_embed_table_shards_vocab(self):
        assert spec(["embed", "table"], (32000, 2048)) == P("model", None)

    def test_attn_out_dim_sharded(self):
        assert spec(["blocks", "attn", "wq", "w"], (48, 4096, 4096)) == \
            P(None, None, "model")
        assert spec(["blocks", "attn", "wo", "w"], (48, 4096, 4096)) == \
            P(None, "model", None)

    def test_mlp_ff_sharded(self):
        assert spec(["blocks", "mlp", "gate", "w"], (48, 4096, 11008)) == \
            P(None, None, "model")
        assert spec(["blocks", "mlp", "down", "w"], (48, 11008, 4096)) == \
            P(None, "model", None)

    def test_moe_expert_sharded(self):
        assert spec(["blocks", "moe", "gate_w"], (48, 64, 2048, 1408)) == \
            P(None, "model", None, None)

    def test_norms_replicated(self):
        assert spec(["blocks", "ln1", "g"], (48, 4096)) == P()

    def test_router_replicated(self):
        assert spec(["blocks", "moe", "router", "w"], (48, 2048, 64)) == P()

    def test_non_divisible_drops_axis(self):
        assert spec(["blocks", "attn", "wq", "w"], (4, 100, 100)) == \
            P(None, None, None)

    def test_replicated_profile(self):
        assert spec(["blocks", "attn", "wq", "w"], (48, 4096, 4096),
                    profile="replicated") == P()


class TestCacheRules:
    def test_kv_cache(self):
        ps = rules.cache_pspec(("k",), (48, 128, 32768, 16, 128), MESH)
        assert ps == P(None, "data", None, "model", None)
        ps = rules.cache_pspec(("k",), (48, 128, 32768, 8, 128), MESH)
        assert ps == P(None, "data", None, None, None)

    def test_kv_cache_multipod(self):
        ps = rules.cache_pspec(("k",), (48, 128, 32768, 16, 128), MP)
        assert ps == P(None, ("pod", "data"), None, "model", None)

    def test_batch1_not_sharded(self):
        ps = rules.cache_pspec(("k",), (48, 1, 1024, 5, 64), MESH)
        assert ps[1] is None

    def test_kv_heads_non_divisible(self):
        ps = rules.cache_pspec(("k",), (48, 128, 32768, 4, 128), MESH)
        assert ps == P(None, "data", None, None, None)


class TestMesh:
    def test_production_meshes(self):
        assert MESH.shape == {"data": 16, "model": 16} and MESH.size == 256
        assert list(MP.shape.items()) == [("pod", 2), ("data", 16),
                                          ("model", 16)]
        assert MP.size == 512
        assert batch_axes(MP) == ("pod", "data") and model_axis(MP) == \
            "model"
        assert batch_axes(MESH) == ("data",)

    def test_host_mesh(self, monkeypatch):
        host = make_host_mesh(device="cpu")
        assert host.axis_names == ("data",) and host.size == 1
        assert model_axis(host) is None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
        with pytest.raises(ValueError, match="pair up"):
            Mesh(("data", "data"), (1, 2))

    def test_constrain_batch_on_host_mesh(self):
        mesh = make_host_mesh(device="cpu")
        x = torch.zeros(4, 8)
        assert rules.constrain_batch(x, mesh) is x

    def test_shard_shape(self):
        sh = rules.NamedSharding(MP, P(("pod", "data"), None, "model"))
        assert sh.shard_shape((64, 3, 32)) == (2, 3, 2)
        with pytest.raises(ValueError, match="does not divide"):
            sh.shard_shape((48, 3, 32))


# ------------------------------------------------------ the JAX trees --

def jax_key(path):
    return tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path)


def padded(sp, ndim):
    return tuple(sp) + (None,) * (ndim - len(tuple(sp)))


def jdtype(leaf):
    return np.dtype(leaf.dtype).name


def tdtype(leaf):
    return str(leaf.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def cells():
    """Per (arch, shape, w8): the JAX and the port's trees of the cell
    (w8 only for the serve shapes, as JAX quantizes only there)."""
    out = {}
    for arch in list_archs():
        for w8 in (False, True):
            jcfg, tcfg = jax_config(arch), get_config(arch)
            if w8:
                jcfg, tcfg = jcfg.replace(quant=JW8), tcfg.replace(quant=W8)
            japi, tapi = jax_get_model(jcfg), get_model(tcfg)
            for name, shape in LM_SHAPES.items():
                if w8 and shape.kind == "train":
                    continue
                out[arch, name, w8] = (
                    japi, JS.shape_trees(japi, JLM[name], JTC),
                    tapi, TS.shape_trees(tapi, shape, TC))
    return out


def flat_jax(tree):
    return {jax_key(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree):
    return dict(leaves_with_paths(tree))


class TestShapeTrees:
    def test_paths_shapes_dtypes(self, cells):
        """Every operand of every cell (w8's int8 trees included): the
        same paths, shapes and dtypes as JAX's ``shape_trees``."""
        for (arch, name, w8), (_, jt, _, tt) in cells.items():
            assert sorted(jt) == sorted(tt), (arch, name)
            for part in jt:
                j, t = flat_jax(jt[part]), flat_port(tt[part])
                assert sorted(j) == sorted(t), (arch, name, w8, part)
                for path, leaf in j.items():
                    got = t[path]
                    assert tuple(got.shape) == tuple(leaf.shape), \
                        (arch, name, w8, part, path)
                    assert tdtype(got) == jdtype(leaf), \
                        (arch, name, w8, part, path)
                    # the decode position and AdamW's count are host
                    # scalars, as on the card
                    host = path in (("pos",), ("count",))
                    assert (got.device.type == "cpu") == host, \
                        (arch, name, part, path)

    def test_w8_quantizes_serve_weights(self, cells):
        _, _, _, tt = cells["tinyllama-1.1b", "decode_32k", True]
        wq = tt["params"]["blocks"]["attn"]["wq"]["w"]
        assert set(wq) == {"q", "scale"} and wq["q"].dtype == torch.int8

    def test_inputs_are_input_specs(self, cells):
        for (arch, name, _), (japi, jt, tapi, tt) in cells.items():
            specs = tapi.input_specs(LM_SHAPES[name])
            jspecs = japi.input_specs(LM_SHAPES[name])
            assert sorted(specs) == sorted(jspecs)
            for k, s in specs.items():
                assert tuple(s.shape) == tuple(jspecs[k].shape)
                assert tdtype(s) == jdtype(jspecs[k]), (arch, name, k)


class TestSpecParity:
    @pytest.mark.parametrize("mesh_kind", sorted(MESHES))
    @pytest.mark.parametrize("profile", PROFILES)
    def test_every_leaf(self, cells, mesh_kind, profile):
        """params and inputs of every cell, opt of the train cell and the
        cache of decode_32k: the port's spec is JAX's, leaf for leaf."""
        tmesh, jmesh = MESHES[mesh_kind]
        n = 0
        for (arch, name, w8), (japi, jt, tapi, tt) in cells.items():
            if w8 or name not in ("train_4k", "decode_32k"):
                continue
            js = JS.cell_shardings(japi, None, jmesh, jt, profile)
            ts = TS.cell_shardings(tapi, None, tmesh, tt, profile)
            assert sorted(js) == sorted(ts)
            for part in js:
                jl, tl = flat_jax(js[part]), flat_port(ts[part])
                leaves = flat_port(tt[part])
                assert sorted(jl) == sorted(tl), (arch, part)
                for path, jsh in jl.items():
                    nd = len(leaves[path].shape)
                    assert padded(tl[path].spec, nd) == \
                        padded(jsh.spec, nd), (arch, name, part, path)
                    n += 1
        assert n > 500

    @pytest.mark.parametrize("mesh_kind", sorted(MESHES))
    def test_argument_bytes(self, cells, mesh_kind):
        """Per-device bytes of every operand of every cell under
        ``default``: the port's ``shard_bytes`` is the sum of JAX's shard
        shapes' bytes."""
        tmesh, jmesh = MESHES[mesh_kind]
        for (arch, name, w8), (japi, jt, tapi, tt) in cells.items():
            js = JS.cell_shardings(japi, None, jmesh, jt)
            ts = TS.cell_shardings(tapi, None, tmesh, tt)
            want = 0
            for part in js:
                shards = flat_jax(js[part])
                for path, leaf in flat_jax(jt[part]).items():
                    sh = JaxNamedSharding(jmesh, shards[path].spec)
                    want += math.prod(sh.shard_shape(leaf.shape)) * \
                        np.dtype(leaf.dtype).itemsize
            got = sum(rules.shard_bytes(tt[k], ts[k]) for k in ts)
            assert got == want, (arch, name, w8, mesh_kind)


def test_param_pspec_takes_jax_paths():
    """One rule serves both packages' paths: a JAX ``DictKey`` path
    gives the port's spec."""
    path = (jax.tree_util.DictKey("blocks"), jax.tree_util.DictKey("attn"),
            jax.tree_util.DictKey("wq"), jax.tree_util.DictKey("w"))
    want = jrules.param_pspec(path, (22, 2048, 2048),
                              MESHES["pod"][1])
    assert padded(rules.param_pspec(path, (22, 2048, 2048), MESH), 3) == \
        padded(want, 3)

"""int8 gradient compression with error feedback, over a process group.

The port of ``repro.train.grad_compress``: HLS4PC's fixed-point and
LFSR ideas applied to the data-parallel gradient all-reduce.  Each
gradient leaf (plus its carried error) is scaled by the group's largest
``absmax / 127``, rounded to int8 stochastically by uniform bits
(``core.quant.stochastic_round_int8``), summed over the group, and
dequantized; what the rounding lost stays on the rank as the error fed
into its next step (EF-SGD).

The wire payload of the sum is int32, in JAX's form and here: JAX psums
``q.astype(int32)``, and so does this module, which is what keeps the
sum of 512 ranks' |q| <= 127 from overflowing.  JAX's "1 byte/param"
(:func:`compression_wire_bytes`) is JAX's own accounting of an int8
body, kept as JAX states it; neither package sends int8 today.

The collectives are ``sharding.collectives.all_reduce_`` over the axes'
groups of a ``launch.mesh.Mesh`` on a process group (NCCL on the card,
gloo on the CPU).  With no mesh, or axes of one device, they are the identity, as
JAX's are over an axis of size 1.  The rounding bits are an argument:
one integer tensor a leaf holding uniform values below 2**32 (a
``torch.Generator``'s draws on the card; JAX's own ``jax.random.bits``
in the parity test).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.core.quant import stochastic_round_int8
from repro_torch.sharding import collectives as C
from repro_torch.sharding.context import current_mesh
from repro_torch.tree import tree_leaves, tree_map, unflatten_like


def _groups(axis_names: Sequence[str], mesh) -> Tuple[list, int]:
    """(the process group of each axis that has more than one device,
    the product of the axes' sizes)."""
    groups, n = [], 1
    for ax in axis_names:
        size = 1 if mesh is None else mesh.shape.get(ax, 1)
        if size > 1:
            group = C.process_group(mesh, ax)
            if group is None:
                raise NotImplementedError(
                    f"compressed psum over axis {ax!r} ({size} devices) of "
                    f"an abstract mesh: moving values needs a process group "
                    f"(launch.mesh.make_host_mesh under init_distributed)")
            groups.append(group)
        n *= size
    return groups, n


def make_compressed_psum(axis_names: Tuple[str, ...], mesh=None):
    """``psum_int8(grads, errs, bits) -> (reduced, new_errs)`` over the
    groups of ``axis_names`` on ``mesh`` (the current mesh where None,
    read at each call).  ``bits`` is a tree like ``grads``.  Per leaf:
    ``gf = g.float() + e``; the scale ``max(max|gf|, 1e-12) / 127``
    all-reduced with MAX; ``q`` its stochastic int8 rounding; the new
    error ``gf - q * scale``; ``q`` summed as int32; the mean
    ``sum * scale / n``.  Two collectives a leaf, as JAX's, and JAX's
    roundings as XLA compiles them: the two divisions by constants are
    products with float32 reciprocals, and the new error is one
    multiply-add."""
    def psum_int8(grads: Any, errs: Any, bits: Any) -> Tuple[Any, Any]:
        groups, n = _groups(axis_names, mesh if mesh is not None
                            else current_mesh())
        outs, new_errs = [], []
        for g, e, b in zip(tree_leaves(grads), tree_leaves(errs),
                           tree_leaves(bits)):
            gf = g.float() + e
            # XLA compiles JAX's division by a constant to a product with
            # the constant's float32 reciprocal; the port takes that
            # product, by a device tensor (exact-rounded on every device)
            scale = torch.clamp(gf.abs().max(), min=1e-12) * \
                gf.new_tensor(1.0 / 127.0)
            for grp in groups:                 # scalar max all-reduce
                C.all_reduce_(scale, grp, "max")
            q = stochastic_round_int8(gf, scale, b)
            # rounded once, as XLA fuses it into a multiply-add: q * scale
            # is exact in float64, and so (all but always) is the sum
            new_errs.append((gf.double() - q.double() * scale.double())
                            .float())
            total = q.to(torch.int32)
            for grp in groups:                 # int32-payload sum
                C.all_reduce_(total, grp)
            outs.append(total.float() * scale * gf.new_tensor(1.0 / n))
        return unflatten_like(grads, outs), unflatten_like(grads, new_errs)
    return psum_int8


def init_error_state(params: Any) -> Any:
    """f32 zeros shaped like each leaf, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compression_wire_bytes(params: Any) -> Tuple[int, int]:
    """(fp32 bytes, int8 bytes) an all-reduce, JAX's accounting: 4 and 1
    a parameter (the port's sum sends int32, 4 a parameter; module
    docstring)."""
    n = sum(x.numel() for x in tree_leaves(params))
    return 4 * n, 1 * n

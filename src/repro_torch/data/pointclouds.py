"""Synthetic parametric point-cloud dataset (ModelNet40 stand-in), drawn with numpy.

The port of ``repro.data.pointclouds``: 8 parametric shape classes with
random rigid transforms, anisotropic scaling and jitter.  JAX draws with
``jax.random``; the port draws with numpy, keyed by
``np.random.SeedSequence([seed, step])``, so a batch is a pure function
of (seed, step) and a resumed run sees exactly the batches it would have
seen.  The two packages' draws differ; their geometry does not:
:func:`shape_points` is ``repro.data.pointclouds._shape_points`` as a
function of its uniform draws, so a test can feed it JAX's own.

Every batch is made on the host in float32 and then moved to ``device``
(``cuda`` unless the caller asks for the CPU), so the CPU and the card
see the same bits.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

CLASS_NAMES = ("sphere", "cube", "cylinder", "cone", "torus",
               "pyramid", "disk", "helix")
N_CLASSES = len(CLASS_NAMES)

_F32 = np.float32
_TWO_PI = _F32(2.0 * np.pi)
_HALF_PI = _F32(np.pi / 2)
_EVAL_DOMAIN = 777777           # eval batches: seed + this, as in JAX


def shape_points(cls: int, u: np.ndarray, v: np.ndarray,
                 w: np.ndarray) -> np.ndarray:
    """Points [n, 3] f32 of class ``cls`` from three uniform draws in
    [0, 1) of shape [n]: ``u`` and ``v`` parametrize the surface, ``w``
    picks the cube's face (the other classes ignore it)."""
    u, v, w = (np.asarray(a, _F32) for a in (u, v, w))
    th = _TWO_PI * u
    ph = np.arccos(_F32(2) * v - _F32(1))
    one = np.ones_like(u)
    if cls == 0:                                   # sphere
        pts = (np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th), np.cos(ph))
    elif cls == 1:                                 # cube
        face = (w * _F32(6)).astype(np.int32)
        a, b = _F32(2) * u - _F32(1), _F32(2) * v - _F32(1)
        faces = np.stack([
            np.stack([one, a, b], -1), np.stack([-one, a, b], -1),
            np.stack([a, one, b], -1), np.stack([a, -one, b], -1),
            np.stack([a, b, one], -1), np.stack([a, b, -one], -1)], 0)
        return faces[face, np.arange(u.shape[0])]
    elif cls == 2:                                 # cylinder
        pts = (np.cos(th), np.sin(th), _F32(2) * v - _F32(1))
    elif cls == 3:                                 # cone
        r = _F32(1) - v
        pts = (r * np.cos(th), r * np.sin(th), _F32(2) * v - _F32(1))
    elif cls == 4:                                 # torus
        r_min = _F32(0.35)
        ph2 = _TWO_PI * v
        ring = _F32(1) + r_min * np.cos(ph2)
        pts = (ring * np.cos(th), ring * np.sin(th), r_min * np.sin(ph2))
    elif cls == 5:                                 # pyramid
        r = _F32(1) - v
        sq_th = np.round(th / _HALF_PI) * _HALF_PI
        mix = _F32(0.7)
        ang = mix * sq_th + (_F32(1) - mix) * th
        pts = (r * np.cos(ang), r * np.sin(ang), _F32(2) * v - _F32(1))
    elif cls == 6:                                 # disk
        r = np.sqrt(u)
        ph2 = _TWO_PI * v
        pts = (r * np.cos(ph2), r * np.sin(ph2),
               _F32(0.05) * (_F32(2) * u - _F32(1)))
    elif cls == 7:                                 # helix
        t = _F32(4) * _TWO_PI * u
        pts = (_F32(0.8) * np.cos(t), _F32(0.8) * np.sin(t),
               _F32(2) * u - _F32(1) + _F32(0.08) * np.sin(_TWO_PI * v))
    else:
        raise ValueError(f"class must be in [0, {N_CLASSES}), got {cls}")
    return np.stack(pts, -1).astype(_F32)


def rotation_zyx(a: np.ndarray) -> np.ndarray:
    """Composed z-y-x axis rotations [3, 3] f32 from three angles."""
    ca, sa = np.cos(np.asarray(a, _F32)), np.sin(np.asarray(a, _F32))
    rz = np.array([[ca[0], -sa[0], 0], [sa[0], ca[0], 0], [0, 0, 1]], _F32)
    ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]], _F32)
    rx = np.array([[1, 0, 0], [0, ca[2], -sa[2]], [0, sa[2], ca[2]]], _F32)
    return rz @ ry @ rx


def _normalize(pts: np.ndarray) -> np.ndarray:
    """Centre a cloud and scale it into the unit sphere."""
    pts = pts - pts.mean(axis=0, keepdims=True)
    return pts / (np.linalg.norm(pts, axis=-1).max() + _F32(1e-6))


def _one_cloud(rng: np.random.Generator, n_points: int
               ) -> Tuple[np.ndarray, int]:
    cls = int(rng.integers(0, N_CLASSES))
    u, v, w = rng.random((3, n_points), _F32)
    pts = shape_points(cls, u, v, w)
    rot = rotation_zyx(rng.uniform(0, 2 * np.pi, 3))
    scale = rng.uniform(0.7, 1.3, 3).astype(_F32)
    pts = (pts * scale) @ rot.T
    pts = pts + _F32(0.02) * rng.standard_normal(pts.shape, _F32)
    return _normalize(pts).astype(_F32), cls


def _device(device) -> torch.device:
    from repro_torch.api.build import resolve_device
    return resolve_device(device)


def make_batch(seed: int, step: int, n_points: int, batch: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch ``step`` of the stream of ``seed``: (points [B, N, 3] f32,
    each cloud centred and inside the unit sphere; labels [B] int64), on
    ``device`` (default ``cuda``; raises without a GPU)."""
    dev = _device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    clouds = [_one_cloud(rng, n_points) for _ in range(batch)]
    pts = np.stack([c for c, _ in clouds])
    labels = np.array([c for _, c in clouds], np.int64)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(labels).to(dev)


def make_stream(seed: int, n_points: int, frames: int, drift: float = 0.02,
                device=None) -> Tuple[torch.Tensor, int]:
    """A frame-coherent LiDAR-style sequence of one rigid body: frame 0
    is a normalized shape sample (no jitter), each later frame a small
    random rigid motion of the last (angles and translation uniform in
    ``+-drift/2``) plus ``0.1 * drift`` Gaussian jitter a point.
    Returns (points [frames, N, 3] f32 on ``device``, label)."""
    dev = _device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    cls = int(rng.integers(0, N_CLASSES))
    u, v, w = rng.random((3, n_points), _F32)
    pts = shape_points(cls, u, v, w)
    scale = rng.uniform(0.7, 1.3, 3).astype(_F32)
    pts = _normalize((pts * scale) @ rotation_zyx(
        rng.uniform(0, 2 * np.pi, 3)).T)
    seq = [pts]
    for _ in range(frames - 1):
        ang = rng.uniform(-drift / 2, drift / 2, 3)
        t = rng.uniform(-drift / 2, drift / 2, 3).astype(_F32)
        nxt = seq[-1] @ rotation_zyx(ang).T + t
        seq.append(nxt + _F32(0.1 * drift)
                   * rng.standard_normal(nxt.shape, _F32))
    return torch.from_numpy(np.stack(seq).astype(_F32)).to(dev), cls


def dataset(seed: int, n_points: int, batch: int, start_step: int = 0,
            device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The infinite stream of :func:`make_batch` batches from
    ``start_step`` on: a run resumed at step s sees the batches an
    uninterrupted run saw from s."""
    step = start_step
    while True:
        yield make_batch(seed, step, n_points, batch, device)
        step += 1


def eval_set(seed: int, n_points: int, n_batches: int, batch: int,
             device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fixed held-out batches, from a seed domain apart from training's
    (``seed + 777777``, as in JAX)."""
    return [make_batch(seed + _EVAL_DOMAIN, i, n_points, batch, device)
            for i in range(n_batches)]

"""Multi-device MSM: points sharded over the mesh, partial sums combined.

Port of the JAX package's ``parallel/msm.py`` (the replacement for the
reference's chunk-per-thread Pippenger, ``best_multiexp``,
arithmetic.rs:132-159).  Each mesh device runs ``ops.msm.msm_many`` on its
contiguous slice of scalars and points (``msm_digits`` ->
``ec_window_table`` -> ``ec_window_fold`` -> ``ec_horner`` on that card),
giving one projective partial per column; the D partials are gathered onto
the scalars' device and folded by ``_reduce_points`` (K2).  The result is the
same group element as the one-device MSM, so callers compare it, or write
it, in affine form.
"""

from __future__ import annotations

from ..curves.point import Point
from ..curves.spec import CurveSpec
from ..ops import msm as msm_ops
from .mesh import DeviceMesh, gather, scatter


def sharded_msm_many(curve: CurveSpec, scalars_mont, points: Point, mesh: DeviceMesh,
                     c: int = 0) -> Point:
    """m MSMs over one shared base set, the n points split over the mesh.

    scalars_mont: (m, 16, n) Montgomery scalar limbs; points: a (16, n)
    Point; n must divide evenly over the mesh.  Returns a projective Point
    with coordinates (16, m) on the scalars' device.
    """
    ndev = mesh.size
    n = scalars_mont.shape[2]
    assert n % ndev == 0, "point count must divide evenly across the mesh"
    if c == 0:
        c = msm_ops.choose_window(n // ndev)
    coords = [scatter(mesh, t) for t in points]
    parts = [msm_ops.msm_many(curve, s, Point(*(t[d] for t in coords)), c)
             for d, s in enumerate(scatter(mesh, scalars_mont))]
    stacked = Point(*(gather(mesh, [p[i].unsqueeze(-1) for p in parts], scalars_mont.device)
                      for i in range(3)))  # (16, m, D)
    return msm_ops._reduce_points(curve, stacked)


def sharded_msm(curve: CurveSpec, scalars_mont, points: Point, mesh: DeviceMesh,
                c: int = 0) -> Point:
    """sum_i scalars[i] * points[i] for (16, n) Montgomery scalars, the points
    split over the mesh; a single projective Point (coordinates (16,))."""
    r = sharded_msm_many(curve, scalars_mont.unsqueeze(0), points, mesh, c)
    return Point(r.x[:, 0], r.y[:, 0], r.z[:, 0])

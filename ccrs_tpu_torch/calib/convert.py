"""Camera-model conversion.

Port of ``ccrs_tpu/calib/convert.py`` (``convert_model``,
``src/util.rs:225-282``, and the grid-fit ModelConvertFactor,
``src/optimization/factors.rs:11-76``): UCM embeds analytically into EUCM;
any other target is fitted by projecting a dense unprojected pixel grid
through both models and minimizing the difference with the dense LM core
(Huber 1.0, standard bounds, disabled distortions honored).  The 10000-px
penalty for unprojectable grid points mirrors factors.rs:71.

On the card the grid's unprojection and the source's projection are
graphs (``models.base.project_on``), and the fit is ``lm_solve``'s device
loop: one graph for its start and one per chunk of iterations, the grid
in its buffers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import GenericModel
from ..models.base import project_on, unproject_on
from ..models.projections import project_fn
from ..solve.lm import LMOptions, lm_solve
from .single import build_bounds, disabled_free_mask

INVALID_PENALTY = 10000.0  # factors.rs:71
F64 = torch.float64


def conversion_grid(source: GenericModel, step_ratio: int = 30, device="cuda"):
    """The reference's conversion grid (factors.rs:33-43 + util.rs:246-247):
    pixels on a [edge, size-edge) lattice with step max(w,h)/30, unprojected
    through the source model (invalid points dropped).  Returns (M, 3)
    float64 rays on ``device``."""
    size = max(source.width, source.height)
    edge = int(size) // 100
    step = int(size / step_ratio)
    rr = np.arange(edge, int(source.height) - edge, step)
    cc = np.arange(edge, int(source.width) - edge, step)
    grid = np.stack(np.meshgrid(cc, rr), -1).reshape(-1, 2).astype(np.float64)
    rays, valid = unproject_on(
        source.name,
        torch.as_tensor(source.params, dtype=F64, device=device),
        torch.as_tensor(grid, dtype=F64, device=device),
    )
    return rays[valid]


def convert_model(
    source: GenericModel, target: GenericModel, disabled_distortions: int = 0,
    device="cuda",
) -> None:
    """Fit ``target``'s parameters to reproduce ``source`` (in place)."""
    if source.name == "ucm" and target.name in ("eucm", "eucmt"):
        # analytic embed: alpha copies, beta=1 (+ t1=t2=0) — util.rs:230-244
        extra = [1.0] if target.name == "eucm" else [1.0, 0.0, 0.0]
        target.set_params(np.concatenate([source.params, extra]))
        return

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=F64, device=device)

    p3ds = conversion_grid(source, device=device)
    src_p2d, src_valid = project_on(source.name, t(source.params), p3ds)

    theta0 = target.params.copy()
    theta0[:4] = source.camera_params()  # util.rs:256-258
    lo, hi = build_bounds(target, one_focal=False)
    free = disabled_free_mask(target, False, disabled_distortions)
    theta0 = np.where(free == 0.0, 0.0, theta0)
    lo = np.where(free == 0.0, -np.inf, lo)
    hi = np.where(free == 0.0, np.inf, hi)

    theta, _, _ = lm_solve(
        _grid_residual(target.name), t(theta0), lo=t(lo), hi=t(hi), free=t(free),
        opts=LMOptions(huber_delta=1.0), data=(p3ds, src_p2d, src_valid),
    )
    target.set_params(theta.cpu().numpy())


@functools.lru_cache(maxsize=None)
def _grid_residual(name: str):
    """The grid fit's residual for a target model: target minus source
    pixels, the penalty where either model cannot project.  One function
    per model, so that every fit of a shape replays one graph."""
    proj_tgt = project_fn(name)

    def residual(theta, p3ds, src_p2d, src_valid):
        tgt_p2d, tgt_valid = proj_tgt(theta, p3ds)
        diff = src_p2d - tgt_p2d
        ok = src_valid & tgt_valid
        diff = torch.where(ok[:, None], diff, torch.full_like(diff, INVALID_PENALTY))
        return diff, torch.ones_like(diff[:, 0])

    return residual

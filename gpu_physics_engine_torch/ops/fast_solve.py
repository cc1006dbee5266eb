"""The sort + shift Jacobi collision solve
(``gpu_physics_engine_tpu.ops.fast_solve``).

SimConfig.solver="fast" on the array Engine:

  1. candidate entries: 4N slot-major (cell, idx, x, y, r) entries, slot 0
     the home cell, slots 1-3 the three neighbours toward the nearest
     corner of the home cell (a circle with r <= cell/2.2 can overlap no
     other), UNUSED where the circle misses the neighbour;
  2. one sort by cell id with x, y and r riding along, so the occupants
     of a cell are adjacent and carry their own positions;
  3. K-1 window passes d = 1..K-1: entries p and p+d of one cell run are a
     pair; both sides' corrections accumulate through shifted elementwise
     ops (Jacobi within the pass).  A pair that shares several cells is
     applied only in the cell of its contact point;
  4. the corrections go back to entry order and the four slot planes of
     each particle are folded.

Runs longer than K miss their distant pairs and count in the overflow.

Where the JAX package sorts unstably, this sorts stably
(``torch.sort(stable=True)``): the stable order is one legal order of the
unstable sort, and it makes the window sums (whose f32 rounding depends on
the order of equal keys) the same on the card and on the CPU.  The sort by
entry index that JAX uses to undo the first permutation is an index copy
here: the indices are unique, so it is the same function.  With
``fast_pack_bf16`` (the default) each entry's correction is rounded to
bf16 (to nearest even) and widened back before the fold, as JAX's packing
of the two corrections into one u32 payload does; without it they stay
f32.  The fold adds the slot planes in slot order, ((s0 + s1) + s2) + s3.

Plain PyTorch: no hand kernel (the JAX module is XLA).  Cell ids are u32
values held in int64 tensors (ops/morton); ``cell_size`` is a 0-d f32
tensor on the particles' device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gpu_physics_engine_torch.core.config import SimConfig, UNUSED_CELL_ID
from gpu_physics_engine_torch.ops import morton
from gpu_physics_engine_torch.ops.grid import _circle_in_cell, home_cells
from gpu_physics_engine_torch.ops.integrate import f32, sqrt_rn

_I32 = torch.int32
MIN_DISTANCE = 1e-4

# the three fixed neighbour slots, as multiples of the nearest-corner signs
_CORNER_SLOTS = ((1, 0), (0, 1), (1, 1))


def build_candidate_entries(x, y, radius, active, cell_size):
    """Flat [4N] candidate entries (cells int64, idx int32, x, y, r):
    slot-major, entry s * N + i is particle i's slot s."""
    n = x.shape[0]
    sq_r = radius * radius
    hx, hy = home_cells(x, y, cell_size)
    frac_x = x - (hx.float() + 0.5) * cell_size
    frac_y = y - (hy.float() + 0.5) * cell_size
    one = torch.ones_like(hx)
    sx = torch.where(frac_x >= 0, one, -one)
    sy = torch.where(frac_y >= 0, one, -one)

    cells = [torch.where(active, morton.morton_encode(hx, hy),
                         UNUSED_CELL_ID)]
    for ox, oy in _CORNER_SLOTS:
        ncx = hx + sx * ox
        ncy = hy + sy * oy
        hit = _circle_in_cell(x, y, sq_r, ncx, ncy, cell_size) & active
        cells.append(torch.where(hit, morton.morton_encode(ncx, ncy),
                                 UNUSED_CELL_ID))
    idx = torch.arange(4 * n, dtype=_I32, device=x.device)
    return (torch.cat(cells), idx, x.repeat(4), y.repeat(4),
            radius.repeat(4))


def _shift_up(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a[p + d], ``fill`` past the end."""
    return torch.cat([a[d:], a.new_full((d,), fill)])


def _shift_down(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a[p - d], ``fill`` before the start."""
    return torch.cat([a.new_full((d,), fill), a[:-d]])


def solve_fast(x, y, radius, active, cell_size, config: SimConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Jacobi relaxation: (new x, new y, overflow i32 [])."""
    K = config.max_occupancy
    stiffness = f32(config.stiffness)
    mind = f32(MIN_DISTANCE)
    n = x.shape[0]

    cells, _, px, py, pr = build_candidate_entries(x, y, radius, active,
                                                   cell_size)
    cells_s, perm = torch.sort(cells, stable=True)
    xs, ys, rs = px[perm], py[perm], pr[perm]
    valid = cells_s != UNUSED_CELL_ID

    acc_x = torch.zeros_like(xs)
    acc_y = torch.zeros_like(ys)
    for d in range(1, K):
        same = (cells_s == _shift_up(cells_s, d, UNUSED_CELL_ID)) & valid
        xj = _shift_up(xs, d, 0.0)
        yj = _shift_up(ys, d, 0.0)
        rj = _shift_up(rs, d, 0.0)

        dx = xs - xj
        dy = ys - yj
        dist = sqrt_rn(dx * dx + dy * dy)
        rsum = rs + rj
        hit = same & (rsum * rsum > dist * dist) & (dist > mind)

        # apply the pair only in the cell holding its contact point
        rsum_safe = torch.clamp(rsum, min=mind)
        t_contact = rs / rsum_safe
        cpx = xs - dx * t_contact
        cpy = ys - dy * t_contact
        ccx = torch.floor(cpx / cell_size).to(_I32)
        ccy = torch.floor(cpy / cell_size).to(_I32)
        hit = hit & (morton.morton_encode(ccx, ccy) == cells_s)
        safe = torch.clamp(dist, min=mind)
        pen = (rsum - dist) * stiffness
        cxv = dx / safe * pen
        cyv = dy / safe * pen
        wi = rj / rsum_safe
        wj = rs / rsum_safe

        hitf = hit.float()
        acc_x = acc_x + cxv * wi * hitf
        acc_y = acc_y + cyv * wi * hitf
        # the j side, shifted back onto the p + d entries
        acc_x = acc_x - _shift_down(cxv * wj * hitf, d, 0.0)
        acc_y = acc_y - _shift_down(cyv * wj * hitf, d, 0.0)

    # a run longer than the K window misses its distant pairs
    over = (cells_s == _shift_up(cells_s, K, UNUSED_CELL_ID)) & valid
    overflow = torch.sum(over, dtype=_I32)

    if config.fast_pack_bf16:
        acc_x = acc_x.to(torch.bfloat16).float()
        acc_y = acc_y.to(torch.bfloat16).float()
    ax = torch.empty_like(acc_x)
    ay = torch.empty_like(acc_y)
    ax[perm] = acc_x
    ay[perm] = acc_y
    ax = ax.view(4, n)
    ay = ay.view(4, n)
    dx_dense = ((ax[0] + ax[1]) + ax[2]) + ax[3]
    dy_dense = ((ay[0] + ay[1]) + ay[2]) + ay[3]
    return x + dx_dense, y + dy_dense, overflow

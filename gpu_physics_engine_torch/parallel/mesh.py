"""A one-process slab mesh (``gpu_physics_engine_tpu.parallel.mesh``).

The JAX package's mesh is one process over ``jax.devices()[:n]``, and its
sharded steps are ``shard_map`` programs over a 1D mesh axis.  Here a
``Mesh`` is an ordered list of torch devices, one per slab; the same
device may repeat, which is how one card (or the CPU, in the tests) runs
every slab, as XLA's virtual host devices do for the JAX package.  A
sharded step runs phase by phase over the slabs in one Python loop, and
each collective of ``shard_map`` is a list operation here:

  * ``Mesh.ppermute(per_slab, shift)``: ``jax.lax.ppermute`` with the
    permutation i -> i + shift; each tensor moves to the receiving
    slab's device, and the slabs nobody sends to get zeros;
  * ``Mesh.psum(per_slab)``: the sum, on every slab's device;
  * the slab index of the loop stands for ``jax.lax.axis_index``.

There are no threads; on one device an exchange is a copy.
``shard_tiles`` / ``gather_tiles`` carry a tile state across: the
[cap, TYp, TX] planes cut into per-slab [cap, rows, TX] TileStates whose
num_active and overflow_count are the replicated counters, kept on
``mesh.devices[0]``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gpu_physics_engine_torch.ops import tiled
from gpu_physics_engine_torch.ops.tiled import TileState


def _resolved(device) -> torch.device:
    """``device`` with the current CUDA index filled in ("cuda" ->
    "cuda:0"), so it compares equal to the device its tensors report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """An ordered list of devices, one per slab (repeats allowed)."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [_resolved(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one slab")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def ppermute(self, per_slab: Sequence[torch.Tensor],
                 shift: int) -> List[torch.Tensor]:
        """Slab i's tensor goes to slab i + shift (a copy on the receiving
        slab's device); the slabs at the mesh edge that nobody sends to
        receive zeros of their own tensor's shape."""
        n = self.size
        out = []
        for j, dev in enumerate(self.devices):
            src = j - shift
            if 0 <= src < n:
                out.append(per_slab[src].to(dev, copy=True))
            else:
                out.append(torch.zeros_like(per_slab[j], device=dev))
        return out

    def psum(self, per_slab: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the slabs, on every slab's device (one tensor,
        shared by the slabs of the first device)."""
        dev0 = self.devices[0]
        total = per_slab[0].to(dev0)
        for t in per_slab[1:]:
            total = total + t.to(dev0)
        copies = {dev0: total}
        return [copies.setdefault(d, total.to(d)) for d in self.devices]


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """``n_devices`` slabs.  With ``device``, all on that device (the
    counterpart of XLA's virtual host devices: ``device="cpu"`` in the
    tests, ``"cuda"`` for every slab on one card); without it, one slab
    per visible CUDA device, ``cuda:0`` .. ``cuda:n-1`` (all of them when
    ``n_devices`` is None or 0).  Raises when there are too few CUDA
    devices; it never picks the CPU by itself."""
    if device is not None:
        return Mesh([device] * max(1, int(n_devices or 1)))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = int(n_devices or have)
    if n < 1 or have < n:
        raise RuntimeError(f"need {max(n, 1)} CUDA devices, have {have}; "
                           "pass device='cpu' (or 'cuda') to put every "
                           "slab on one device")
    return Mesh([torch.device("cuda", i) for i in range(n)])


PlaneSource = Union[TileState, Dict[str, np.ndarray]]


def shard_tiles(state: PlaneSource, mesh: Mesh) -> List[TileState]:
    """Cut [cap, TYp, TX] planes (a TileState, or host arrays keyed like
    ``tiled.to_numpy``'s output, e.g. a JAX sharded TileState gathered
    with ``np.asarray``) into ``mesh.size`` slabs of TYp / n rows, each on
    its slab's device.  Every slab carries the same num_active and
    overflow_count tensors, on ``mesh.devices[0]``."""
    if not isinstance(state, TileState):
        state = tiled.from_numpy(state)
    cap, TYp, TX = state.dims
    n = mesh.size
    if TYp % n:
        raise ValueError(f"{TYp} tile rows do not split into {n} slabs")
    rows = TYp // n
    dev0 = mesh.devices[0]
    num_active = state.num_active.to(dev0, copy=True)
    overflow = state.overflow_count.to(dev0, copy=True)
    slabs = []
    for i, dev in enumerate(mesh.devices):
        cut = {f: getattr(state, f)[:, i * rows:(i + 1) * rows].to(
            dev, copy=True).contiguous() for f in tiled.FIELDS}
        slabs.append(TileState(**cut, num_active=num_active,
                               overflow_count=overflow))
    return slabs


def gather_tiles(slabs: Sequence[TileState], device=None) -> TileState:
    """The inverse of ``shard_tiles``: one TileState with the slabs'
    planes stacked by rows, on ``device`` (default the first slab's)."""
    dev = torch.device(device) if device is not None else slabs[0].device
    planes = {f: torch.cat([getattr(s, f).to(dev) for s in slabs], dim=1)
              for f in tiled.FIELDS}
    return TileState(**planes,
                     num_active=slabs[0].num_active.to(dev),
                     overflow_count=slabs[0].overflow_count.to(dev))

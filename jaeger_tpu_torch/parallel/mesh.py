"""Counterpart of `jaeger_tpu/parallel/mesh.py`: device meshes in PyTorch.

One process drives several devices here. JAX's single-controller
``Mesh`` becomes a :class:`DeviceMesh`: an ordered tuple of
``torch.device`` and an axis name. ``shard_along`` splits a tensor's rows
(or any dimension) over the devices, ``replicate`` puts a copy of a module
or tensor on each device, ``gather`` puts the pieces back together in
order, and :func:`pad_to_multiple` is JAX's padding arithmetic. A device
may appear more than once (``("cpu", "cpu")``, ``("cuda:0", "cuda:0")``):
the pieces then share that device, which is how the CPU tests and a
one-card machine run widths above 1.

:func:`use_mesh` is the counterpart of ``jax.set_mesh``: code that runs
under it (a Hyena operator built with ``parallel.seq_axis``) finds the
mesh with :func:`current_mesh`. Several processes (data-parallel
training, ``jax.distributed``) are :mod:`jaeger_tpu_torch.parallel.
multihost`'s.
"""

from __future__ import annotations

import contextlib
import copy

import torch

#: the ambient meshes, innermost last. A module global, not a context
#: variable: a recomputing backward (``model.remat``) runs the forward
#: again on autograd's own thread, which must see the same mesh.
_STACK: list = []


class DeviceMesh:
    """A 1-D mesh: ``devices`` in order and the name of their axis."""

    def __init__(self, devices, axis: str = "data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        self.axis = str(axis)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"DeviceMesh(({names}), axis={self.axis!r})"

    def shard_along(self, x: torch.Tensor, dim: int = 0) -> list:
        """``x`` cut into ``size`` equal pieces along ``dim``, piece ``i``
        on ``devices[i]`` (the size along ``dim`` must be a multiple)."""
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"dimension {dim} of size {n} does not split "
                             f"over {self.size} devices")
        return [part.to(dev, non_blocking=True) for part, dev in
                zip(torch.chunk(x, self.size, dim=dim), self.devices)]

    def replicate(self, obj) -> list:
        """A copy of ``obj`` (a module or a tensor) on each device. A
        module already on a device is used there as it is; a repeated
        device gets the same copy again."""
        if isinstance(obj, torch.Tensor):
            return [obj.to(dev) for dev in self.devices]
        copies: dict = {}
        home = _module_device(obj)
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = (obj if dev == home
                               else copy.deepcopy(obj).to(dev))
            out.append(copies[dev])
        return out

    def gather(self, parts, dim: int = 0, device=None) -> torch.Tensor:
        """The pieces concatenated along ``dim`` in mesh order, on
        ``device`` (default the first device)."""
        dev = self.devices[0] if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in parts], dim=dim)


def _module_device(module) -> torch.device | None:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return None


def visible_width(dev, want: int) -> int:
    """How many devices of ``dev``'s kind a width of ``want`` can use:
    the visible cards for a bare ``cuda`` (one for ``cuda:N``, the card
    the caller named), ``want`` on the CPU, which a mesh may repeat."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return want
    return torch.cuda.device_count() if dev.index is None else 1


def mesh_of(dev, width: int, axis: str) -> DeviceMesh:
    """A mesh of ``width`` devices of ``dev``'s kind: the cards ``cuda:0``
    on for a bare ``cuda``, else ``dev`` repeated."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return DeviceMesh([f"cuda:{i}" for i in range(width)], axis)
    return DeviceMesh([dev] * width, axis)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh | None):
    """Run the block with ``mesh`` as the ambient mesh (``None`` leaves
    the ambient mesh as it is)."""
    if mesh is None:
        yield current_mesh()
        return
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh() -> DeviceMesh | None:
    """The ambient mesh (:func:`use_mesh`), or None."""
    return _STACK[-1] if _STACK else None

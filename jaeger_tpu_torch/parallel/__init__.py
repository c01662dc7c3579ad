"""Counterpart of `jaeger_tpu/parallel/__init__.py`.

Multi-device execution: device meshes for one process
(:mod:`~jaeger_tpu_torch.parallel.mesh`), process groups for several
(:mod:`~jaeger_tpu_torch.parallel.multihost`) and the sequence-sharded
Hyena ring (:mod:`~jaeger_tpu_torch.parallel.hyena_sp`)."""

from jaeger_tpu_torch.parallel.mesh import (DeviceMesh, mesh_of,
                                            pad_to_multiple)

__all__ = ["DeviceMesh", "mesh_of", "pad_to_multiple"]

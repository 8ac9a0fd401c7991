"""Production device meshes and the H100's hardware constants.

Port of ``repro/launch/mesh.py``.  The production deployment is 256
H100 cards as a ("data", "model") mesh of (32, 8), named ``h100_32x8``
in artifacts; two pods are ("pod", "data", "model") = (2, 32, 8),
``h100_2x32x8``.  The model axis is 8 wide so that tensor parallelism
stays inside one HGX H100 node, whose 8 cards share one NVLink domain.
The JAX package's (16, 16) TPU mesh is not kept: a 16-wide model axis
would put every tensor-parallel collective across two nodes.

As in the JAX package, the "pod" axis doubles as the trainer-instance
axis: inner steps reduce over "data" only, and only the outer step
and merging cross "pod" (``launch.dryrun``'s ``--adloco-outer``).

These are functions, not constants: a ``DeviceMesh`` needs an
initialised process group of the mesh's size (``launch.dryrun`` makes a
fake one of 256 or 512 ranks), and importing this module touches no
process group.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# One H100 SXM; the one source of the first three is cluster.node.
from repro_torch.cluster.node import HBM_BW, LINK_BW, PEAK_FLOPS  # noqa: F401

#: HBM3 bytes of one H100 SXM (NVIDIA H100 Tensor Core GPU datasheet:
#: 80 GB)
HBM_BYTES = 80 * 10 ** 9
#: shared memory per SM of compute capability 9.0 (CUDA C++ Programming
#: Guide, "Technical Specifications per Compute Capability": 228 KB)
SMEM_PER_SM = 228 * 1024

PRODUCTION_SHAPE = (32, 8)
MULTI_POD_SHAPE = (2, 32, 8)


def mesh_name(multi_pod: bool = False) -> str:
    """The production mesh's name in dry-run artifacts."""
    return "h100_2x32x8" if multi_pod else "h100_32x8"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The (32, 8) or (2, 32, 8) mesh of cards over the initialised
    process group (of 256 or 512 ranks)."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh() -> DeviceMesh:
    """(n, 1) over the n cards this host has (the CPU as (1, 1) without
    one), over the initialised process group of n ranks."""
    if torch.cuda.is_available():
        return init_device_mesh("cuda", (torch.cuda.device_count(), 1),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))

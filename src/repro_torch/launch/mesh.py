"""Production mesh construction and the H100 constants of the roofline.

The port of the reference's ``launch/mesh.py`` onto ``torch.distributed``'s
``DeviceMesh`` (functions, not constants: importing this module touches no
process group).  The meshes keep the reference's card counts, so a dry-run
cell compares card for card: ``(data=32, model=8)`` is 256 H100s, 32 nodes
of 8 with the ``model`` axis one node's NVLink domain; ``multi_pod`` adds
``pod=2`` in front, 512 cards.  A mesh is made over the default process
group, which must hold exactly its cards (the dry run starts a ``"fake"``
group of that size).

No TPU constant is carried over.  The constants are an NVIDIA H100 80GB
HBM3 (SXM5, 700 W) card's, from its datasheet, except the usable device
memory, which was measured on such a card (PERF.md section 4).
"""
from __future__ import annotations

PRODUCTION_SHAPE = (32, 8)          # (data, model): 32 nodes of 8 cards
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 32, 8)        # (pod, data, model): 512 cards
MULTI_POD_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (data=32, model=8) mesh, or (pod=2, data=32, model=8)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = MULTI_POD_AXES if multi_pod else PRODUCTION_AXES
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type="cuda"):
    """A one-card mesh (axes exist, size 1) over a world-1 group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=PRODUCTION_AXES)


# --- NVIDIA H100 80GB HBM3 (SXM5, 700 W) constants (roofline) ---------------
# dense bf16 tensor-core peak, per card (datasheet: 1,979 TFLOP/s with
# sparsity, half of it dense)
PEAK_FLOPS_BF16 = 989.4e12
# HBM3 bandwidth per card (datasheet)
HBM_BW = 3.35e12
# NVLink 4 per card, per direction (datasheet: 900 GB/s bidirectional);
# carries the ``model`` axis, one node's 8 cards
NVLINK_BW = 450e9
# InfiniBand NDR per card, per direction: one 400 Gb/s ConnectX-7 a card;
# carries the ``data`` and ``pod`` axes, across nodes
IB_BW = 50e9
# usable device memory, measured on the card: torch.cuda.mem_get_info's
# total on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 4)
HBM_BYTES = 79.18 * 2 ** 30

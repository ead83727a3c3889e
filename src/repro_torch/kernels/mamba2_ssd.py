"""Chunked Mamba-2 SSD scan: the Hopper kernel and its plain version.

The prefill hot path of the hybrid family (zamba2).  ``mamba2_ssd_cuda`` is
the port of the reference's ``mamba2_ssd_pallas``.  On a CUDA tensor it
launches the hand-written kernel in ``csrc/mamba2_ssd.cu`` (built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``, bound through
``ctypes``); on a CPU tensor it runs ``mamba2_ssd_plain``, the same
function in plain PyTorch.  Any other device raises: there is no fallback
from the kernel to the plain version.

Contract (the reference kernel's): x (Bt, L, H, P), dt (Bt, L, H),
A (H,), B and C (Bt, L, N), all widened to fp32; L a multiple of the chunk.
Within a chunk ``y = (C B^T o L)(dt x) + exp(cum) (C state^T)`` with
``L[t, s] = exp(cum_t - cum_s)`` for t >= s (else 0) and ``cum`` the
chunk's cumulative sum of ``dt A``; the (P, N) state carries across
chunks.  Returns (y (Bt, L, H, P) fp32, final state (Bt, H, P, N) fp32).
No ``D`` skip and no initial state: the model adds the skip outside.

The kernel takes strides over (batch, time), so the model's x, B and C,
which are column slices of one projection, go in without a copy.

Two paths, chosen per call by the pure function ``plan``: the staged path
(three kernels: chunk states, state passing, chunk scan; tensor cores with
the fp32 factors split into bf16 hi and lo parts) for P and N in
``STAGED_DIMS``, a chunk that is a multiple of 16 up to
``STAGED_MAX_CHUNK`` and 16-byte aligned x, B and C; the general path (one
block per (sequence, head) walking its chunks on the FMA units) for the
rest.  ``last_plan`` holds the path of the last CUDA call.  Asked for
``stages``, both the kernel and the plain version also return the staged
intermediates: the chunk states, each chunk's total log-decay and the
state entering each chunk.

Training differentiates through ``MambaSSD``: the kernel forward, and as
backward on the card the hand-written backward kernels in
``csrc/mamba2_ssd_bwd.cu`` (the forward's stages reversed: chunk states,
a forward and a reverse state pass, the chunk gradients, the sums over
heads; no float atomics), two paths chosen by the pure function
``plan_backward``: the chunk states and gradients on the tensor cores
(mma.sync, fp32 factors split into bf16 hi and lo, as the forward's
staged path) at the training shapes, else on the FMA units; on the CPU
the gradient of the plain version
for x, dt, A, B and C in plain PyTorch (``mamba2_ssd_backward``, a
sequence at a time), which the kernels are held against on the card.
The final state takes no gradient.

The scan is the operator ``repro_torch::mamba2_ssd``
(``torch.library.custom_op``, with a fake implementation and a flop
formula), so a mesh's ``local_map`` and the dry run's meta-tensor trace
see one operator, not the plain version.
"""
from __future__ import annotations

import ctypes
import re

import torch

from repro_torch.kernels import _build, trace

MAX_DIM = 128           # P and N: the widest instantiated thread layout
STAGED_DIMS = (16, 32, 64)  # P and N of the staged path (SSD_STAGED_DIMS)
STAGED_MAX_CHUNK = 256      # its largest chunk (kMaxChunk)

# launches of the CUDA kernel: one per wrapper call, on either path; of
# the backward kernels: one per backward call (its four kernels)
launches = 0
backward_launches = 0
# the path ("staged" or "general") of the last call on the card, and of
# the last backward call ("tensor" or "general")
last_plan = None
last_backward_plan = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ci, _vp = ctypes.c_int, ctypes.c_void_p
_strides = ctypes.POINTER(ctypes.c_longlong)
# the C functions of csrc/mamba2_ssd.cu: (argument types, result type)
_SIGNATURES = {
    "ssd_forward": ([_ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _ci,
                     _ci, _ci, _ci, _strides, _vp], _ci),
    "ssd_staged": ([_ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                    _ci, _ci, _ci, _ci, _ci, _ci, _strides, _vp], _ci),
    "ssd_error_string": ([_ci], ctypes.c_char_p),
}
# those of csrc/mamba2_ssd_bwd.cu
_BWD_SIGNATURES = {
    "ssd_backward": ([_ci, _ci, *[_vp] * 18, _ci, _ci, _ci, _ci, _ci, _ci,
                      _strides, _vp], _ci),
    "ssd_backward_error_string": ([_ci], ctypes.c_char_p),
}
_lib = None
_bwd_lib = None


def build(verbose: bool = False):
    """Compile ``csrc/mamba2_ssd.cu`` into ``build/kernels/`` unless a
    library built from the same sources and flags is already there;
    returns its path."""
    return _build.build("mamba2_ssd", verbose)


def build_backward(verbose: bool = False):
    """``build`` of the backward kernels, ``csrc/mamba2_ssd_bwd.cu``."""
    return _build.build("mamba2_ssd_bwd", verbose)


def _bind(name, signatures):
    lib = _build.library(name)
    for fn, (args, res) in signatures.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = _bind("mamba2_ssd", _SIGNATURES)
    return _lib


def _backward_library():
    global _bwd_lib
    if _bwd_lib is None:
        _bwd_lib = _bind("mamba2_ssd_bwd", _BWD_SIGNATURES)
    return _bwd_lib


# the backward's paths: "general" (up to MAX_DIM, FMAs, 32-row tiles, the
# per-row arrays in a global scratch of ROW_ARRAYS x chunk floats a
# (sequence, chunk, head)), "tensor" (P and N in TC_DIMS, a chunk that is a
# multiple of 16 up to TC_MAX_CHUNK, aligned x, B and C: the chunk states
# and gradients on the tensor cores, fp32 factors split into bf16 hi and
# lo, the whole chunk's tiles in shared memory, which the source's
# static_assert fits within a block at TC_MAX_CHUNK)
BACKWARD_PATHS = ("general", "tensor")   # the C side's path codes
TC_DIMS = (16, 32, 64)     # SSD_BWD_TC_DIMS
TC_MAX_CHUNK = 256         # kTcMaxChunk
MAX_SMEM = 232448          # shared memory a block may take (227 KB)
ROW_ARRAYS = 5             # kRowArrays


def backward_smem(P: int, N: int, chunk: int) -> int:
    """Bytes of shared memory the general path's chunk kernel takes
    (``chunk_smem_floats`` in ``csrc/mamba2_ssd_bwd.cu``, 32-row tiles): the
    x dt and dy tiles, the B and C tiles, two score tiles, the row sums'
    partials, the cumulative log-decay."""
    rt = 32
    p4, n4 = -(-P // 4) * 4, -(-N // 4) * 4
    floats = 2 * rt * (p4 + 4) + 2 * rt * (n4 + 4) + 2 * rt * (rt + 4) + \
        16 * rt + chunk + 16
    return 4 * floats


def plan_backward(P: int, N: int, chunk: int, aligned: bool = True) -> str:
    """The path a backward call takes: ``"tensor"`` for P and N in
    ``TC_DIMS``, a chunk that is a multiple of 16 up to ``TC_MAX_CHUNK`` and
    ``aligned`` x, B and C (16-byte addresses and row strides); else
    ``"general"`` (P and N up to ``MAX_DIM``) where its shared memory fits;
    raises where neither does (a chunk of tens of thousands of rows, beyond
    what the forward takes)."""
    if max(P, N) > MAX_DIM:
        raise ValueError(f"mamba2_ssd_backward: P={P}, N={N} above the "
                         f"kernel's {MAX_DIM}")
    if P in TC_DIMS and N in TC_DIMS and chunk % 16 == 0 and \
            chunk <= TC_MAX_CHUNK and aligned:
        return "tensor"
    if backward_smem(P, N, chunk) <= MAX_SMEM:
        return "general"
    raise ValueError(f"mamba2_ssd_backward: a chunk of {chunk} rows needs "
                     f"{backward_smem(P, N, chunk)} bytes of shared memory, "
                     f"above {MAX_SMEM}")


def plan(P: int, N: int, chunk: int, aligned: bool) -> str:
    """The path a call takes: ``"staged"`` for P and N in ``STAGED_DIMS``,
    a chunk that is a multiple of 16 up to ``STAGED_MAX_CHUNK`` and
    ``aligned`` x, B and C (16-byte addresses and row strides), else
    ``"general"``."""
    if P in STAGED_DIMS and N in STAGED_DIMS and chunk % 16 == 0 and \
            chunk <= STAGED_MAX_CHUNK and aligned:
        return "staged"
    return "general"


def aligned(*tensors) -> bool:
    """Whether each tensor's address and its strides over (batch, time)
    are multiples of 16 bytes, as the staged path's 16-byte loads need."""
    return all(t.data_ptr() % 16 == 0 and
               all(t.stride(d) * t.element_size() % 16 == 0 for d in (0, 1))
               for t in tensors)


def mamba2_ssd_plain(x, dt, A, B, C, *, chunk: int, stages: bool = False):
    """The kernel's function in plain PyTorch, on whatever device the
    tensors are on: the chunked fp32 math, intra-chunk quadratic form and
    a sequential pass over the chunks' states.  The CPU path, and what the
    kernel is held against on the card.  With ``stages`` it also returns
    the staged path's intermediates, {"chunk_state": (Bt, nc, H, P, N),
    "chunk_total": (Bt, nc, H), "passed_state": (Bt, nc, H, P, N)}: the
    state each chunk adds alone, its total log-decay and the state
    entering it."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    c, nc = chunk, L // chunk
    dtf = dt.float()
    xdt = (x.float() * dtf[..., None]).reshape(Bt, nc, c, H, P)
    cum = torch.cumsum((dtf * A.float()).reshape(Bt, nc, c, H), dim=2)
    Bc = B.float().reshape(Bt, nc, c, N)
    Cc = C.float().reshape(Bt, nc, c, N)
    # (C B^T o L) xdt within each chunk; exp only where t >= s
    G = torch.einsum("bjtn,bjsn->bjts", Cc, Bc)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (Bt,nc,t,s,H)
    decay = torch.where(causal, torch.exp(seg.masked_fill_(~causal, 0.0)),
                        0.0)
    y = torch.einsum("bjtsh,bjshp->bjthp", decay.mul_(G[..., None]), xdt)
    # the carried state, chunk by chunk
    total = cum[:, :, -1]                                  # (Bt,nc,H)
    w = torch.exp(total[:, :, None, :] - cum)              # (Bt,nc,c,H)
    dBx = torch.einsum("bjthp,bjtn->bjhpn", xdt * w[..., None], Bc)
    st = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    passed = []
    for j in range(nc):
        passed.append(st)
        y[:, j] += torch.exp(cum[:, j])[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc[:, j], st)
        st = torch.exp(total[:, j])[:, :, None, None] * st + dBx[:, j]
    if not stages:
        return y.reshape(Bt, L, H, P), st
    return y.reshape(Bt, L, H, P), st, {
        "chunk_state": dBx, "chunk_total": total,
        "passed_state": torch.stack(passed, dim=1)}


def _check(x, dt, A, B, C, chunk):
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("mamba2_ssd: x (Bt,L,H,P), dt (Bt,L,H), A (H,), "
                         "B and C (Bt,L,N)")
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (Bt, L, H) or tuple(A.shape) != (H,) or \
            tuple(B.shape) != (Bt, L, N) or tuple(C.shape) != (Bt, L, N):
        raise ValueError(f"mamba2_ssd: bad shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    if min(Bt, L, H, P, N) < 1 or chunk < 1 or L % chunk != 0:
        raise ValueError(f"mamba2_ssd: L={L} is not a multiple of the chunk "
                         f"{chunk}")
    if len({t.device for t in (x, dt, A, B, C)}) != 1:
        raise ValueError("mamba2_ssd: tensors on several devices")


def _check_kernel(x, dt, A, B, C, chunk):
    """What either CUDA path takes, beyond ``_check``."""
    if len({x.dtype, B.dtype, C.dtype}) != 1 or x.dtype not in _DTYPE_CODE:
        raise ValueError("mamba2_ssd: x, B and C must be all fp32 or all "
                         "bf16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("mamba2_ssd: dt and A must be fp32")
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"mamba2_ssd: P={P}, N={N} above the kernel's "
                         f"{MAX_DIM}")
    if x.stride(3) != 1 or x.stride(2) != P or dt.stride(2) != 1 or \
            B.stride(2) != 1 or C.stride(2) != 1 or not A.is_contiguous():
        raise ValueError("mamba2_ssd: the (H, P) of x, the H of dt and the N "
                         "of B and C must be contiguous")
    if max(H, Bt, L // chunk) > 65535:
        raise ValueError("mamba2_ssd: too many heads, sequences or chunks "
                         "for the grid")


def _ssd_cuda(x, dt, A, B, C, chunk: int, stages: bool):
    global launches, last_plan
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    path = plan(P, N, chunk, aligned(x, B, C))
    lib = _library()
    dev = x.device
    y = torch.empty((Bt, L, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 8)(
        x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1))
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr())
    staged = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "staged":
            nc = L // chunk
            staged = {
                "chunk_state": torch.empty((Bt, nc, H, P, N),
                                           dtype=torch.float32, device=dev),
                "chunk_total": torch.empty((Bt, nc, H), dtype=torch.float32,
                                           device=dev),
                "passed_state": torch.empty((Bt, nc, H, P, N),
                                            dtype=torch.float32, device=dev)}
            err = lib.ssd_staged(
                _DTYPE_CODE[x.dtype], *ptrs,
                staged["chunk_state"].data_ptr(),
                staged["passed_state"].data_ptr(),
                staged["chunk_total"].data_ptr(), Bt, L, H, P, N, chunk,
                strides, stream)
        else:
            err = lib.ssd_forward(_DTYPE_CODE[x.dtype], *ptrs, Bt, L, H, P,
                                  N, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd: {path} kernel launch failed: "
                           + lib.ssd_error_string(err).decode())
    launches += 1
    last_plan = path
    return (y, state, staged) if stages else (y, state)


# The scan as the operator ``repro_torch::mamba2_ssd``: its real
# implementation launches the kernel on CUDA tensors (and raises on any
# other); its fake one gives the outputs' shapes, so a trace on meta
# tensors (the mesh dry run) records the operator and never the plain
# version.  ``repro_torch::mamba2_ssd_backward`` stands for the backward
# in such a trace: the gradient is autograd's through the plain version,
# which an operator's body cannot record, so on a device ``MambaSSD``
# calls ``mamba2_ssd_backward`` itself and the operator's body raises.
# The operators' namespace is ``repro_torch`` for the package's module; any
# other copy of the module (``kernel_compare.py`` loads another checkout's
# beside it) registers its own operators under its module name, so every
# copy launches through its own.
_NS = "repro_torch" if __name__ == "repro_torch.kernels.mamba2_ssd" \
    else re.sub(r"\W", "_", __name__)


@torch.library.custom_op(f"{_NS}::mamba2_ssd", mutates_args=())
def mamba2_ssd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd: no kernel for device {x.device}")
    _check_kernel(x, dt, A, B, C, chunk)
    return _ssd_cuda(x, dt, A, B, C, chunk, False)


@mamba2_ssd_op.register_fake
def _ssd_fake(x, dt, A, B, C, chunk):
    Bt, L, H, P = x.shape
    return (x.new_empty((Bt, L, H, P), dtype=torch.float32),
            x.new_empty((Bt, H, P, B.shape[-1]), dtype=torch.float32))


def _ssd_backward_cuda(x, dt, A, B, C, dy, chunk: int):
    """(dx, ddt, dA, dB, dC) from the backward kernels, each in its input's
    dtype (dA summed in fp32), on the path ``plan_backward`` gives."""
    global backward_launches, last_backward_plan
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    path = plan_backward(P, N, chunk, aligned(x, B, C))
    dev, nc, n4 = x.device, L // chunk, -(-N // 4) * 4
    dy = dy.to(torch.float32).contiguous()
    dx = torch.empty((Bt, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bt, L, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bt, L, N), dtype=B.dtype, device=dev)
    dC = torch.empty((Bt, L, N), dtype=C.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = [torch.empty((Bt, nc, H, P, n4), **f32),     # S, then In
               torch.empty((Bt, nc, H, P, n4), **f32),     # Q, then dOut
               torch.empty((Bt, nc, H), **f32),            # chunk totals
               torch.empty((Bt, L, H, N), **f32),          # dB a head
               torch.empty((Bt, L, H, N), **f32),          # dC a head
               torch.empty((Bt, nc, H), **f32),            # dA a chunk
               torch.empty((Bt, nc, H, ROW_ARRAYS, chunk), **f32)]  # rows
    strides = (ctypes.c_longlong * 8)(
        x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1))
    lib = _backward_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_backward(
            _DTYPE_CODE[x.dtype], BACKWARD_PATHS.index(path),
            *(t.data_ptr() for t in (x, dt, A, B, C, dy, dx, ddt, dA, dB, dC,
                                     *scratch)),
            Bt, L, H, P, N, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"mamba2_ssd_backward: {path} kernel launch "
                           "failed: "
                           + lib.ssd_backward_error_string(err).decode())
    backward_launches += 1
    last_backward_plan = path
    return dx, ddt, dA.to(A.dtype), dB, dC


@torch.library.custom_op(f"{_NS}::mamba2_ssd_backward", mutates_args=())
def mamba2_ssd_backward_op(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                           dy: torch.Tensor, chunk: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"mamba2_ssd_backward: no kernel for device "
                         f"{x.device}")
    _check(x, dt, A, B, C, chunk)
    _check_kernel(x, dt, A, B, C, chunk)
    return _ssd_backward_cuda(x, dt, A, B, C, dy, chunk)


@mamba2_ssd_backward_op.register_fake
def _ssd_backward_fake(x, dt, A, B, C, dy, chunk):
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (x, dt, A, B, C))


def ssd_flops(x_shape, B_shape, chunk: int) -> float:
    """Flops of one scan: for each (sequence, chunk) C B^T over the
    c (c + 1) / 2 pairs t >= s, and for each head the masked product with
    x dt over the same pairs, the carried state's part of y and the state
    update (2 c P N each).  The mesh dry run counts the operator by this."""
    Bt, L, H, P = x_shape
    N = B_shape[-1]
    c = min(chunk, L)
    nc = L // c
    pairs = c * (c + 1) // 2
    return 2.0 * Bt * nc * pairs * N + \
        Bt * H * nc * (2.0 * pairs * P + 4.0 * c * P * N)


def _register_flops():
    from torch.utils.flop_counter import flop_registry, register_flop_formula
    ops = getattr(torch.ops, _NS)
    if ops.mamba2_ssd in flop_registry:
        return

    @register_flop_formula(ops.mamba2_ssd)
    def _fwd(x, dt, A, B, C, chunk, *args, out_shape=None, **kw):
        return int(ssd_flops(x, B, chunk))

    @register_flop_formula(ops.mamba2_ssd_backward)
    def _bwd(x, dt, A, B, C, dy, chunk, *args, out_shape=None, **kw):
        # the forward recomputed, then twice its products for the inputs
        return int(3 * ssd_flops(x, B, chunk))


_register_flops()


def _forward(x, dt, A, B, C, chunk, stages):
    """The kernel on a CUDA tensor (through its operator, unless the staged
    intermediates are asked for), the operator's fake implementation on a
    meta tensor inside ``trace.meta_operators()``, the plain version on a
    CPU tensor; any other device raises."""
    if x.device.type == "cpu":
        return mamba2_ssd_plain(x, dt, A, B, C, chunk=chunk, stages=stages)
    if x.device.type == "meta" and not stages and \
            trace.operator_device(x.device):
        return mamba2_ssd_op(x, dt, A, B, C, chunk)
    _check_kernel(x, dt, A, B, C, chunk)
    if x.device.type == "cuda":
        if stages:
            return _ssd_cuda(x, dt, A, B, C, chunk, stages)
        return mamba2_ssd_op(x, dt, A, B, C, chunk)
    raise ValueError(f"mamba2_ssd: no kernel for device {x.device}")


def mamba2_ssd_backward(x, dt, A, B, C, dy, *, chunk: int):
    """(dx, ddt, dA, dB, dC): the gradient of ``mamba2_ssd_plain``'s y at
    (x, dt, A, B, C) for the gradient ``dy``, by autograd through the plain
    version recomputed one sequence at a time; each in its input's dtype
    (dA summed over the sequences in fp32).  Plain PyTorch on every
    device."""
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in (x, dt, B, C)]
    dA = torch.zeros(A.shape, dtype=torch.float32, device=A.device)
    Af = A.detach().requires_grad_()
    with torch.profiler.record_function("mamba2_ssd.backward"):
        for b in range(x.shape[0]):
            ins = [t[b:b + 1].detach().requires_grad_()
                   for t in (x, dt, B, C)]
            with torch.enable_grad():
                y, _ = mamba2_ssd_plain(ins[0], ins[1], Af, ins[2], ins[3],
                                        chunk=chunk)
                g = torch.autograd.grad(y, (*ins, Af), dy[b:b + 1])
            for out, gi in zip(outs, g):
                out[b:b + 1] = gi
            dA += g[4].float()
    dx, ddt, dB, dC = outs
    return dx, ddt, dA.to(A.dtype), dB, dC


class MambaSSD(torch.autograd.Function):
    """The SSD scan that autograd differentiates.  Forward: ``_forward``,
    the hand-written kernel on the card (launched again where a
    checkpointed block is recomputed).  Backward: on the card the backward
    kernels (``mamba2_ssd_backward_op``); on the CPU the gradient of
    ``mamba2_ssd_plain`` for x, dt, A, B and C in plain PyTorch
    (``mamba2_ssd_backward``), the gradient the port defines (the
    reference differentiates its jnp ``ssd_chunked`` the same way and has
    no backward kernel), which the kernels are held against on the card.
    The final state is not differentiable (training never reads it)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state = _forward(x, dt, A, B, C, chunk, False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        if dy.device.type == "cpu":
            g = mamba2_ssd_backward(*ctx.saved_tensors, dy, chunk=ctx.chunk)
        elif trace.operator_device(dy.device):
            with torch.profiler.record_function("mamba2_ssd.backward"):
                g = mamba2_ssd_backward_op(*ctx.saved_tensors,
                                           dy.contiguous(), ctx.chunk)
        else:
            raise ValueError(f"mamba2_ssd: no kernel for device {dy.device}")
        return (*g, None)


def mamba2_ssd_cuda(x, dt, A, B, C, *, chunk: int = 256,
                    stages: bool = False):
    """x: (Bt, L, H, P); dt: (Bt, L, H); A: (H,); B, C: (Bt, L, N).
    Returns (y (Bt, L, H, P) fp32, state (Bt, H, P, N) fp32), with the
    chunk ``min(chunk, L)``: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  With ``stages`` a third item holds the staged
    intermediates (see ``mamba2_ssd_plain``); the general path has none
    (None).  A call without ``stages`` goes through ``MambaSSD`` (which
    records nothing where grad is off or no input requires it)."""
    chunk = min(chunk, x.shape[1])
    _check(x, dt, A, B, C, chunk)
    if stages:
        return _forward(x, dt, A, B, C, chunk, True)
    return MambaSSD.apply(x, dt, A, B, C, chunk)

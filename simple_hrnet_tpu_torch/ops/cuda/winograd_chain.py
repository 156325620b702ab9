"""B3: HRNet's branch-0 chain with Winograd F(2,3) along H — CUDA kernel and
plain version.

Counterpart of ``simple_hrnet_tpu/ops/pallas/winograd_chain.py`` (the Pallas
``_wino_kernel`` behind ``chain_pallas_grouped_wino``), computing its
UNPACKED function (G = 1). The kernel is ``csrc/winograd_chain.cu``; its
note gives the bound on the H100 and the design.

Each 3x3 conv of the 4-BasicBlock chain is computed over row pairs
(2t, 2t+1) from the four input rows 2t-1 .. 2t+2 (H even):

  V0 = x[2t-1] - x[2t+1]   V1 = x[2t] + x[2t+1]
  V2 = x[2t+1] - x[2t]     V3 = x[2t] - x[2t+2]
  m_u = sum over kx, ci of V_u[x + kx - 1, ci] * U[u, kx, ci, co]
  y[2t]   = bias + m0 + m1 + m2
  y[2t+1] = bias + m1 - m2 - m3

with U the ky taps transformed by the F(2,3) G matrix. The cast points are
``_wino_kernel``'s: the V terms are differences of activation-type values
rounded to the activation type, U is in the activation type, the dots
accumulate in f32, the bias, the f32 residual of the block input and the
ReLU follow in f32, and each conv's output is cast once.

``wino_chain`` checks the operands' shapes and calls the custom op
``sht::wino_chain`` (``torch.library.custom_op``): its CPU implementation is
the plain version, its CUDA one the kernel launch, which raises where the
kernel does not take the operands, and its fake implementation gives
``torch.export`` the output's shape and type, so an exported graph holds
the op (``utils/export.py``). ``wino_chain.launches`` counts every kernel
launch, eager or from an exported program.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from simple_hrnet_tpu_torch.ops.cuda import build

# G matrix of F(2,3) applied to the ky axis (a copy of the JAX package's
# winograd_chain._G)
_G = np.array([[1.0, 0.0, 0.0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0.0, 0.0, 1.0]], np.float32)
# the widths the kernel is compiled for: those where the JAX package runs
# its Winograd chain (G * c == 128 with G = min(4, max(2, 128 // c)))
WINO_WIDTHS = (32, 64)


def takes(c: int) -> bool:
    """Whether the kernel takes chains of width ``c`` (in bf16, with H
    even). The wrapper refuses every other width with this same rule, and
    ``StageModule.pack`` packs Winograd weights only where it holds."""
    return c in WINO_WIDTHS


def pack_winograd_weights(w: torch.Tensor, dtype: torch.dtype
                          ) -> torch.Tensor:
    """(8, 3, 3, C, C) HWIO chain weights in f32 (``pack_chain_weights``
    layout, from the f32 folded convs) -> (8, 4, 3C, C) in ``dtype``: ky
    transformed by G in f32 on the host (numpy, the JAX package's own
    arithmetic), kx taps stacked on the contraction dim in the order
    [x-1 | x | x+1], then cast. Transforming weights already rounded to
    bf16 would give other numbers."""
    if w.dtype != torch.float32:
        raise ValueError(f'pack_winograd_weights wants the f32 folded '
                         f'weights, got {w.dtype}')
    u = np.einsum('uk,ikxab->iuxab', _G, w.detach().cpu().numpy())
    c = u.shape[-1]
    return torch.from_numpy(np.ascontiguousarray(
        u.reshape(8, 4, 3 * c, c))).to(device=w.device, dtype=dtype)


def _wino_conv(v: torch.Tensor, u: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """One Winograd-H conv without its epilogue: v (B, C, H, W) in the
    activation type, u (4, 3C, C) f32 -> bias + conv in f32."""
    h = v.shape[2]
    c = v.shape[1]
    vp = F.pad(v, (0, 0, 1, 1))           # row r holds image row r - 1
    d0, d1 = vp[:, :, 0:h:2], vp[:, :, 1:h + 1:2]
    d2, d3 = vp[:, :, 2:h + 2:2], vp[:, :, 3:h + 2:2]
    terms = (d0 - d2, d1 + d2, d2 - d1, d1 - d3)  # rounded to v's type
    m = [F.conv2d(t.float(), u[i].reshape(3, c, c).permute(2, 1, 0)
                  [:, :, None, :], padding=(0, 1))
         for i, t in enumerate(terms)]
    b = bias.float().view(1, c, 1, 1)
    y_even = b + m[0] + m[1] + m[2]
    y_odd = b + m[1] - m[2] - m[3]
    return torch.stack([y_even, y_odd], dim=3).reshape(v.shape)


def wino_chain_plain(x: torch.Tensor, ww: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x (B, H, W, C) NHWC with H
    even, ww (8, 4, 3C, C) from ``pack_winograd_weights``, b (8, C)."""
    dt = x.dtype
    u = ww.to(dt).float()
    v = x.permute(0, 3, 1, 2)
    for blk in range(4):
        mid = torch.relu(_wino_conv(v, u[2 * blk], b[2 * blk])).to(dt)
        y = _wino_conv(mid, u[2 * blk + 1], b[2 * blk + 1]) + v.float()
        v = torch.relu(y).to(dt)
    return v.permute(0, 2, 3, 1).contiguous()


def wino_chain(x: torch.Tensor, ww: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """4 BasicBlocks on x (B, H, W, C) NHWC, Winograd-H, through the custom
    op ``sht::wino_chain``: the CUDA kernel for CUDA tensors (bf16, C in
    ``WINO_WIDTHS``, any W and even H), the plain version for CPU
    tensors."""
    if x.ndim != 4:
        raise ValueError(f'wino_chain wants x (B, H, W, C), got '
                         f'{tuple(x.shape)}')
    h, c = x.shape[1], x.shape[3]
    if tuple(ww.shape) != (8, 4, 3 * c, c) or tuple(b.shape) != (8, c):
        raise ValueError(f'wino_chain weights {tuple(ww.shape)} / biases '
                         f'{tuple(b.shape)} do not match C = {c}')
    if h % 2:
        raise ValueError(f'wino_chain tiles H in row pairs; H = {h} is odd')
    return _wino_chain_op(x, ww, b)


@torch.library.custom_op('sht::wino_chain', mutates_args=(),
                         device_types='cpu')
def _wino_chain_op(x: torch.Tensor, ww: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    return wino_chain_plain(x, ww, b)


@_wino_chain_op.register_kernel('cuda')
def _wino_chain_cuda(x: torch.Tensor, ww: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """The kernel launch; raises where the kernel does not take the
    operands, never falls back to the plain version."""
    bsz, h, wd, c = x.shape
    if ww.device != x.device or b.device != x.device:
        raise ValueError(f'wino_chain: x on {x.device}, ww on {ww.device}, '
                         f'b on {b.device}; want one CUDA device')
    if x.dtype != torch.bfloat16 or ww.dtype != torch.bfloat16 or \
            b.dtype != torch.float32:
        raise ValueError(f'wino_chain kernel takes bf16 x and ww and f32 b; '
                         f'got {x.dtype}, {ww.dtype}, {b.dtype}')
    if not (x.is_contiguous() and ww.is_contiguous() and b.is_contiguous()):
        raise ValueError('wino_chain kernel wants contiguous x, ww, b')
    if not takes(c):
        # a template per width: the accumulators of a pass and the staged
        # U are sized by C
        raise ValueError(f'wino_chain kernel takes C in {WINO_WIDTHS} (HRNet-'
                         f'W32 branch 0 is 32), got {c}')
    if ww.data_ptr() % 16:
        raise ValueError('wino_chain kernel wants 16-byte aligned weights')
    if x.data_ptr() % 16:  # the kernel's 16-byte vector loads
        x = x.clone()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    mid = torch.empty_like(x)
    tmp = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _fn()(build.ptr(x), build.ptr(ww), build.ptr(b), build.ptr(out),
                   build.ptr(mid), build.ptr(tmp), bsz, h, wd, c,
                   build.stream_ptr(x.device))
    build.check(rc, 'wino_chain kernel')
    wino_chain.launches += 1
    return out


@_wino_chain_op.register_fake
def _wino_chain_fake(x, ww, b):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


wino_chain.launches = 0


def _fn():
    fn = build.library('winograd_chain').sht_wino_chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    return fn

"""Where the JAX package's bf16 elementwise chains round, and whether the
port rounds there too (on the CPU).

XLA's CPU lowering computes a bf16 elementwise op in f32 and converts the
result back to bf16; in a fusion it keeps that convert after every op,
so a chain rounds once an op. PyTorch on bf16 tensors rounds once a call.
For each chain of the JAX package's inference paths this script prints
the ops of the optimized HLO of ``jax.jit`` of the chain on bf16 inputs,
each marked where its f32 result is rounded to bf16, and the elements in
which the port's code for that chain differs from the JAX function on
seeded inputs (0: the port rounds where XLA does):

  * HRNet's residual add + ReLU (``layers.basic_block``);
  * a transition (conv, bias, ReLU: the bias epilogue and the ReLU), and
    the fuse layers' sum + ReLU (``hrnet.py``'s fuse);
  * PoseResNet's head (each transposed conv's bias + ReLU in bf16; the
    final 1x1 conv and its bias in f32);
  * YOLOv5's Bottleneck add and darknet's ``shortcut``;
  * the int8 ``QConv2d`` outside the chains (quantize, the exact int32
    conv, dequantize + bias in f32, one cast), through a 1x1 conv so the
    conv itself is exact on both sides, in bf16 and f32, beside the same
    epilogue in two f32 roundings (XLA contracts it into one FMA);
  * the detectors' sigmoid, SiLU and mish (``ops/activation.py``), with
    PyTorch's one-rounding calls beside them.

Run from the repository root (JAX on the CPU, a few seconds):

    python tests/torch_rounding_audit.py
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

N = 1 << 16  # elements a chain


def _hlo_rounding(fn, *args) -> str:
    """The ops of ``jax.jit(fn)``'s optimized CPU HLO in program order
    (conversions, parameters, constants and broadcasts left out), each
    followed by '->bf16' where a convert to bf16 takes its result."""
    import jax
    text = jax.jit(fn).lower(*args).compile().as_text()
    inst = re.compile(r'^\s*(?:ROOT )?%(\S+) = (\w+)\[[^\]]*\]\S* '
                      r'([\w-]+)\((.*?)\)')
    rows, rounded = [], set()
    for line in text.splitlines():
        m = inst.match(line)
        if not m:
            continue
        name, dtype, op, operands = m.groups()
        if op == 'convert':
            if dtype == 'bf16':
                rounded.update(re.findall(r'%(\S+?)(?:[,)]|$)', operands))
            continue
        if op in ('parameter', 'constant', 'broadcast', 'fusion', 'tuple',
                  'get-tuple-element', 'bitcast', 'reshape', 'copy'):
            continue
        rows.append((name, op))
    return ' '.join(f'{op}{"->bf16" if name in rounded else ""}'
                    for name, op in rows)


def _differ(got, want) -> int:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return int(np.sum((got != want) & ~(np.isnan(got) & np.isnan(want))))


def main() -> int:
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from simple_hrnet_tpu.models import layers as JL
    from simple_hrnet_tpu_torch.models import layers as TL
    from simple_hrnet_tpu_torch.ops import activation as TA
    from simple_hrnet_tpu_torch.ops import int8 as T8

    rng = np.random.default_rng(0)
    c = 64

    def draw(*shape, sd=2.0):
        return rng.normal(0.0, sd, shape).astype(np.float32)

    def bf(a):
        return jnp.asarray(a, jnp.bfloat16)

    def tb(a):
        """NHWC numpy -> the port's NCHW bf16 tensor."""
        t = torch.from_numpy(a).to(torch.bfloat16)
        return t.permute(0, 3, 1, 2) if t.ndim == 4 else t

    def back(t):
        t = t.float()
        return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()

    shape = (4, 16, N // (4 * 16 * c), c)
    a, b, d, e = (draw(*shape) for _ in range(4))
    bias = draw(c, sd=0.5)
    rows = []

    # HRNet residual add + ReLU: JAX layers.basic_block's relu(out +
    # residual); the port's layers.BasicBlock.forward F.relu(out + residual)
    rows.append(('HRNet residual add + ReLU',
                 lambda x, y: JL.relu(x + y), (bf(a), bf(b)),
                 back(F.relu(tb(a) + tb(b)))))
    # a transition / PoseResNet deconv epilogue: JAX conv2d's out +
    # bias.astype(out.dtype), then relu; the port's layers.add_bias, then
    # F.relu
    rows.append(('conv bias + ReLU (transitions, PoseResNet deconvs)',
                 lambda x, p: JL.relu(x + p.astype(x.dtype)),
                 (bf(a), jnp.asarray(bias)),
                 back(F.relu(TL.add_bias(tb(a), torch.from_numpy(bias))))))
    # HRNet's fuse rows: acc = y_0; acc = acc + y_j in j order; relu
    rows.append(('HRNet fuse sum + ReLU',
                 lambda w, x, y, z: JL.relu(((w + x) + y) + z),
                 tuple(bf(t) for t in (a, b, d, e)),
                 back(F.relu(((tb(a) + tb(b)) + tb(d)) + tb(e)))))
    # PoseResNet's final 1x1 conv runs in f32 on the bf16 deconv output:
    # the cast up is exact, the conv and its bias are f32 on both sides
    rows.append(('PoseResNet head input cast + f32 bias',
                 lambda x, p: x.astype(jnp.float32) + p,
                 (bf(a), jnp.asarray(bias)),
                 (tb(a).float() + torch.from_numpy(bias).view(1, -1, 1, 1)
                  ).permute(0, 2, 3, 1).numpy()))
    # YOLOv5's Bottleneck x + y and darknet's shortcut x + outputs[f]
    rows.append(('YOLOv5 Bottleneck add / darknet shortcut',
                 lambda x, y: x + y, (bf(a), bf(b)),
                 back(tb(a) + tb(b))))
    # the detectors' activations: the port's ops/activation.py
    x1 = draw(N, sd=3.0)
    mish = (lambda y: y * jnp.tanh(jax.nn.softplus(y)))
    for name, jf, port, once in (
            ('sigmoid (darknet logistic)', jax.nn.sigmoid, TA.sigmoid,
             torch.sigmoid),
            ('SiLU (YOLOv5 Conv, darknet swish)', jax.nn.silu, TA.silu,
             F.silu),
            ('mish (darknet)', mish, TA.mish,
             lambda t: t * torch.tanh(F.softplus(t)))):
        xt = torch.from_numpy(x1).to(torch.bfloat16)
        rows.append((name, jf, (bf(x1),), back(port(xt)), back(once(xt))))

    print('chain | XLA CPU ops (->bf16: rounded to bf16 after the op) | '
          'port elements differing from JAX')
    for row in rows:
        name, fn, args, port = row[:4]
        want = np.asarray(jax.jit(fn)(*args).astype(jnp.float32))
        extra = (f'; PyTorch\'s one rounding: {_differ(row[4], want)}'
                 if len(row) > 4 else '')
        print(f'{name} | {_hlo_rounding(fn, *args)} | '
              f'{_differ(port, want)} of {want.size}{extra}')

    # the int8 QConv2d: JAX conv2d's kernel_q branch against the port's
    # ops/int8.int8_conv2d, 1x1 (the int32 conv is exact on both sides)
    x8 = draw(*shape, sd=1.0)
    wq = rng.integers(-127, 128, (c, c)).astype(np.int8)
    wscale = rng.uniform(1e-3, 1e-2, c).astype(np.float32)
    ascale = np.float32(np.abs(x8).max() / 127.0)
    p = {'kernel_q': jnp.asarray(wq.T.reshape(1, 1, c, c)),
         'wscale': jnp.asarray(wscale), 'ascale': jnp.asarray(ascale),
         'bias': jnp.asarray(bias)}
    args = (torch.from_numpy(wq), 1, torch.from_numpy(wscale),
            torch.tensor(ascale), torch.from_numpy(bias), 1, 0)
    for label, jdt in (('bf16', jnp.bfloat16), ('f32', None)):
        jfn = (lambda x, q, jdt=jdt: JL.conv2d(x, q, dtype=jdt))
        xin = bf(x8) if jdt is not None else jnp.asarray(bf(x8), jnp.float32)
        want = np.asarray(jax.jit(jfn)(xin, p).astype(jnp.float32))
        xt = tb(x8) if jdt is not None else tb(x8).float()
        got = back(T8.int8_conv2d(xt, *args))
        # the epilogue in two f32 roundings (multiply, then add), as the
        # port computed it before it took XLA's fused multiply-add
        acc = T8.int8_conv_acc(T8.quantize(xt.permute(0, 2, 3, 1),
                                           1.0 / args[3]), args[0], 1, 1, 0)
        two = (acc.float() * (args[3] * args[2]) + args[4]).to(xt.dtype)
        print(f'int8 QConv2d 1x1 {label} (quantize, int32 conv, dequantize '
              f'+ bias in f32, cast) | {_hlo_rounding(jfn, xin, p)} | '
              f'{_differ(got, want)} of {want.size}; in two f32 roundings: '
              f'{_differ(two.float().numpy(), want)}')
    return 0


if __name__ == '__main__':
    sys.exit(main())

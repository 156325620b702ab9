"""Engine export and load — the port's counterpart of
``simple_hrnet_tpu/utils/export.py`` (the reference's TensorRT engine,
scripts/export-tensorrt-model.py:13-28 and SimpleHRNet.py:143-147).

An engine is one ``.torchpose`` file, a zip holding:
  * ``program.pt2`` — the ``torch.export``ed forward of the pose model
    with its folded (and, under int8, quantized) parameters, at a fixed
    batch, resolution and compute type, traced on the device type it is
    meant to serve on;
  * ``meta.json`` — the JAX package's engine keys, plus ``device``.

``fused=True`` exports HRNet's kernel graph: its branch-0 chains and
high-resolution fusions are the custom ops ``sht::basic_chain``,
``sht::wino_chain``, ``sht::int8_chain`` and ``sht::fuse_up``
(``ops/cuda``), nodes of the exported graph that launch the CUDA kernels on
the card and run their plain versions on the CPU. ``fused=False`` exports
the plain graph (``prepare_inference(..., kernels=False)``), as the JAX
package exports ``hrnet.apply``. The op modules are imported here, so the
ops are registered before ``torch.export.load`` reads a graph that holds
them.

``Engine(x)`` takes the normalized NHWC batch the port's pose model takes
and returns its NHWC heatmaps; ``Engine.apply`` pads and chunks any batch
to the engine batch, as the JAX facade's ``engine_apply``.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Iterable, Tuple, Union

import numpy as np
import torch

# registers the custom ops an exported kernel graph calls
from simple_hrnet_tpu_torch.ops.cuda import (fuse_up, fused_block,  # noqa: F401
                                             int8_chain, winograd_chain)
from simple_hrnet_tpu_torch.utils.device import resolve_device, true_f32

SUFFIX = '.torchpose'


def export_engine(out_path: str, checkpoint_path: str, *, c: int = 48,
                  nof_joints: int = 17, model_name: str = 'HRNet',
                  resolution: Tuple[int, int] = (384, 288),
                  batch_size: int = 16, half: bool = False,
                  int8: bool = False, fused: bool = False,
                  int8_exclude: Iterable[str] = (),
                  device: Union[str, torch.device, None] = None) -> str:
    """Fold, quantize and export the pose model of ``checkpoint_path``
    (``.pth``/``.pt`` or ``.npz``) to ``out_path``.

    ``half``: bf16 compute (the reference's fp16 TensorRT mode); ``int8``:
    post-training quantization calibrated on ``quantize.smooth_frames``
    normalized as the serving graph normalizes (subtract, then multiply),
    bf16 elsewhere, with ``int8_exclude`` prefixes kept bf16; ``fused``:
    HRNet's kernel graph (module docstring). ``device``: where the engine
    is traced and will serve, 'cuda' (default; raises without a card) or
    'cpu'."""
    from simple_hrnet_tpu_torch.api import HRNET_NAMES
    from simple_hrnet_tpu_torch.models import hrnet, poseresnet
    from simple_hrnet_tpu_torch.models import layers as L
    from simple_hrnet_tpu_torch.models import quantize as Q
    from simple_hrnet_tpu_torch.models.convert import load_into
    from simple_hrnet_tpu_torch.ops import image as I
    from simple_hrnet_tpu_torch.utils import checkpoint as ckpt

    int8_exclude = tuple(int8_exclude)
    if int8_exclude and not int8:
        raise ValueError('int8_exclude only applies with int8=True '
                         '(nothing is quantized otherwise)')
    dev = resolve_device(device)
    if int8:
        half = True
    dtype = torch.bfloat16 if half else torch.float32
    is_hrnet = model_name in HRNET_NAMES
    net = (hrnet.HRNet(c, nof_joints) if is_hrnet
           else poseresnet.PoseResNet(c, nof_joints))
    model = load_into(net, ckpt.load(checkpoint_path)).to(dev).eval()

    amax = None
    if int8:
        L.fold_batch_norm(model)
        imgs = Q.smooth_frames(resolution, n=2, lo=0.0, hi=255.0)
        cal = ((imgs.astype(np.float32) - I.MEAN255)
               * I.INV255_STD).astype(np.float32)
        amax = Q.calibrate(model, [torch.from_numpy(cal).to(dev)])
        if int8_exclude:
            amax = Q.filter_amax(model, amax, int8_exclude)
    if is_hrnet:
        model = hrnet.prepare_inference(model, dtype, kernels=fused,
                                        amax=amax)
    else:
        model = poseresnet.prepare_inference(model, dtype, amax=amax)

    example = torch.zeros((batch_size, *resolution, 3), dtype=torch.float32,
                          device=dev)
    with torch.no_grad():
        program = torch.export.export(model, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = {'c': c, 'nof_joints': nof_joints, 'model_name': model_name,
            'resolution': list(resolution), 'batch_size': batch_size,
            'half': half, 'int8': int8, 'fused': fused, 'device': dev.type}
    with zipfile.ZipFile(out_path, 'w') as z:
        z.writestr('program.pt2', buf.getvalue())
        z.writestr('meta.json', json.dumps(meta))
    return out_path


class Engine:
    """A loaded ``.torchpose`` engine on ``device`` ('cuda' by default;
    'cpu' when asked for). Loading an engine on another device type than
    it was exported for, or a JAX ``.jaxpose`` engine, raises
    ``ValueError``."""

    def __init__(self, path: str,
                 device: Union[str, torch.device, None] = None):
        dev = resolve_device(device)
        jax_engine = ValueError(
            f'{path!r} is a JAX StableHLO engine (.jaxpose) of the JAX '
            f'package; the port reads {SUFFIX} engines, written by '
            f'python -m simple_hrnet_tpu_torch.cli.export')
        if path.endswith('.jaxpose'):
            raise jax_engine
        with zipfile.ZipFile(path) as z:
            if 'module.shlo' in z.namelist():
                raise jax_engine
            self.meta = json.loads(z.read('meta.json'))
            if self.meta['device'] != dev.type:
                raise ValueError(
                    f'{path!r} was exported for {self.meta["device"]!r} and '
                    f'cannot serve on {dev.type!r}: an engine is traced on '
                    f'the device type it serves on; export it again with '
                    f'--device {dev.type}')
            self.program = torch.export.load(io.BytesIO(
                z.read('program.pt2')))
        self.device = dev
        self.module = self.program.module()

    @property
    def batch_size(self) -> int:
        return self.meta['batch_size']

    @property
    def resolution(self) -> Tuple[int, int]:
        return tuple(self.meta['resolution'])

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(batch_size, H, W, 3) normalized f32 -> (batch_size, H/4, W/4,
        J) f32 heatmaps, in true f32 (TF32 off)."""
        with true_f32():
            return self.module(x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Any batch: zero-padded to a multiple of the engine batch and run
        in chunks of it; the first ``len(x)`` heatmaps are returned."""
        n, eb = x.shape[0], self.batch_size
        if n == eb:
            return self(x)
        total = max(eb, -(-n // eb) * eb)
        if total != n:
            x = torch.cat([x, x.new_zeros((total - n, *x.shape[1:]))])
        return torch.cat([self(x[i:i + eb])
                          for i in range(0, total, eb)])[:n]

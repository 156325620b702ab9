"""Seeded ultralytics-style YOLOv5 checkpoints for the port's tests and
``chip_smoke.py`` (JAX-free).

``write_yolov5_pt`` pickles the port's own YOLOv5 network as ``{'model':
net}``, the layout of an ultralytics ``.pt`` that both packages' stub
loaders read. Its weights are shaped so that the random network behaves
like a detector: torch's default init shrinks the activations through the
~60 convs until every candidate scores alike (the candidate order is then
float noise), so the convs are scaled to He-uniform bounds, BN statistics
are randomized, and the Detect head's weights are scaled by 30 with the
person logit raised by 3. At 128x128 such a yolov5n keeps a few people a
frame of random pixels (about 20 candidates pass the 0.5 threshold), with
their scores apart.
"""

import torch

from simple_hrnet_tpu_torch.detectors import yolov5 as TY


def write_yolov5_pt(path, variant='yolov5n', seed=0, person_logit=3.0):
    """Write the seeded checkpoint to ``path`` and return ``path``."""
    net = TY.init(TY.build_config(variant), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(6 ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.rand(c, generator=g) * 0.4 - 0.2)
                m.running_mean.copy_(torch.rand(c, generator=g) * 0.4 - 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
        for head in net.model['24'].m:
            head.weight.mul_(30 / 6 ** 0.5)
            head.bias.view(3, -1)[:, 5] += person_logit
    torch.save({'model': net}, path)
    return path

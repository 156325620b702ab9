"""The FLOP counts and the detector's activation sizes in each
configuration file, counted again with ``torch.utils.flop_counter`` on the
reference models."""

import pytest

from port_bench.harness import flops, spec

CONFIGS = [c['name'] for c in spec.benchmark_file()['configs']]


@pytest.mark.parametrize('name', CONFIGS)
def test_flops_match_counter(name):
    cfg = spec.config(name)
    assert cfg['flops']['detector_per_frame'] == \
        flops.per_item(cfg['detector'])
    assert cfg['flops']['pose_per_crop'] == flops.per_item(cfg['pose'])


def test_flops_near_published():
    cfg = spec.config('hrnet_w48_384x288-yolov3_416-bf16')
    # darknet's yolov3.cfg at 416: 65.879 BFLOPs
    assert cfg['flops']['detector_per_frame'] == pytest.approx(65.9e9,
                                                               rel=0.01)
    cfg = spec.config('poseresnet50_256x192-yolov5m_640-bf16')
    # ultralytics' yolov5m at 640: 49.0 GFLOPs
    assert cfg['flops']['detector_per_frame'] == pytest.approx(49.0e9,
                                                               rel=0.01)


def test_k4_sizes_match_network():
    cfg = spec.config('poseresnet50_256x192-yolov5m_640-bf16')
    sizes = flops.silu_sizes(cfg['detector'])
    assert cfg['kernels']['k4_elems_per_frame'] == sizes
    assert len(sizes) == 79

"""The reference against the program on the CPU, in f32: the networks
take the same state dicts in the same BN order, the crops are the
program's bit for bit, and a whole small run of each cell (the program's
CPU facade, the harness, the check) comes out correct with the numbers
at rounding."""

import tempfile

import numpy as np
import pytest
import torch

from port_bench.harness import runner, spec
from port_bench.reference import nets, pipeline as R
from port_bench.tests import small


def _port_net(recipe):
    if recipe['kind'] == 'hrnet':
        from simple_hrnet_tpu_torch.models.hrnet import HRNet
        return HRNet(recipe['c'], 17)
    if recipe['kind'] == 'poseresnet':
        from simple_hrnet_tpu_torch.models.poseresnet import PoseResNet
        return PoseResNet(recipe['c'], 17)
    if recipe['kind'] == 'yolov3':
        from simple_hrnet_tpu_torch.detectors import darknet
        return darknet.Darknet(darknet.yolov3_blocks())
    from simple_hrnet_tpu_torch.detectors import yolov5
    return yolov5.YOLOv5Net(yolov5.build_config(recipe['variant']))


RECIPES = [spec.config(c['name'])[part]
           for c in spec.benchmark_file()['configs']
           for part in ('pose', 'detector')]


@pytest.mark.parametrize('recipe', RECIPES,
                         ids=[r['kind'] for r in RECIPES])
def test_state_dicts_and_bn_order_match_program(recipe):
    with torch.device('meta'):
        ref, port = nets.build(recipe), _port_net(recipe)
    assert [(k, tuple(v.shape)) for k, v in ref.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in port.state_dict().items()]
    bn = lambda n: [k for k, m in n.named_modules()
                    if isinstance(m, torch.nn.BatchNorm2d)]
    assert bn(ref) == bn(port)


def test_crop_bitwise_equals_program():
    from simple_hrnet_tpu_torch.ops import image as I
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.integers(0, 256, (96, 128, 3), np.uint8))
    for box in ([10, 5, 60, 90], [-3, 40, 70, 130], [100, -8, 140, 30]):
        rounded = np.asarray(box, np.float32)
        window = R.pad_to_aspect(rounded, 384 / 288)
        got = R.crop(frame, window, rounded, (384, 288)).float()
        want = I.crop_resize_pil(
            frame[None], torch.zeros(1, dtype=torch.long),
            torch.from_numpy(window.astype(np.float32))[None], (384, 288),
            valid_boxes=torch.from_numpy(rounded)[None])[0]
        assert torch.equal(got, want)
        port_window = I.pad_to_aspect(torch.from_numpy(rounded)[None],
                                      384 / 288)[0]
        assert np.array_equal(port_window.numpy(), window.astype(np.float32))


@pytest.fixture(scope='module')
def bench():
    root = tempfile.mkdtemp(prefix='pb_small_')
    return small.make_bench(root), root


@pytest.mark.parametrize('cell', ['small_w8_video', 'small_res18_video',
                                  'small_w8_live'])
def test_small_run_correct_on_cpu(bench, cell):
    b, root = bench
    torch.set_num_threads(4)
    line = runner.run_cell(cell, 2 ** 33 + 7, 2.0, traced=False,
                           device='cpu', bench=b, bench_dir=root)
    numbers = line.pop('_extras')['numbers']
    assert line['correct'], numbers
    assert numbers['people_posed'] > 0 and numbers['people'] > 0
    assert numbers['box_mismatch'] == 0
    assert numbers['people_unmatched'] == 0.0
    # f32 on both sides; the program's phase stem sums in another order
    assert numbers['det_box_px'] < 1e-2 and numbers['det_score_err'] < 1e-3
    assert numbers['kp_gap'] < 1e-4 and numbers['conf_err'] < 1e-4
    assert list(line)[-1] == 'checks'

"""The port's CLIs and host utilities against the JAX package's, on the
CPU: the three parsers, person tracking, drawing, the prefetch iterator,
``extract_keypoints`` and the ``live_demo`` loop.

Tolerances: tracking ids equal and smoothed boxes and poses within 1e-6
(the same numpy arithmetic); drawings bitwise; the extracted keypoints
within 1e-4 (single person on frames the size of the model input, so no
resize: the same heatmaps within 2e-4 and the same argmax).
"""

import csv
import json

import numpy as np
import pytest

import torch
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from simple_hrnet_tpu.cli import export as JX
from simple_hrnet_tpu.cli import extract_keypoints as JK
from simple_hrnet_tpu.cli import live_demo as JL
from simple_hrnet_tpu.data import prefetch as JP
from simple_hrnet_tpu.utils import tracking as JT
from simple_hrnet_tpu.utils import visualization as JV

from simple_hrnet_tpu_torch.cli import export as TX
from simple_hrnet_tpu_torch.cli import extract_keypoints as TK
from simple_hrnet_tpu_torch.cli import live_demo as TL
from simple_hrnet_tpu_torch.data import prefetch as TP
from simple_hrnet_tpu_torch.models import hrnet as TH
from simple_hrnet_tpu_torch.utils import tracking as TT
from simple_hrnet_tpu_torch.utils import visualization as TV

RES = (64, 64)


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                     getattr(a.type, '__name__', a.type))
            for a in parser._actions}


@pytest.mark.parametrize('name', ['export', 'extract_keypoints',
                                  'live_demo'])
def test_parsers_match_jax(name):
    """Every flag of the JAX package's CLI, with its default; the export
    CLI adds ``--device`` (default 'cuda')."""
    port, ref = {'export': (TX, JX), 'extract_keypoints': (TK, JK),
                 'live_demo': (TL, JL)}[name]
    got, want = _flags(port.build_parser()), _flags(ref.build_parser())
    if name == 'export':
        assert got.pop('device') == (('--device',), 'cuda', None, 'str')
        for s in ('stage4, transition3', 'stage4 ,', ''):
            assert TX.parse_int8_exclude(s) == JX.parse_int8_exclude(s)
    assert got == want


@pytest.fixture(scope='module')
def scene():
    """Two frames of people: a swapped pair, one newcomer, and a pose
    with a far-off joint (the e <= 29 filter drops it from the OKS mean)."""
    rng = np.random.default_rng(0)
    prev_boxes = np.array([[10, 10, 60, 120], [100, 20, 160, 140],
                           [200, 40, 240, 110]], np.float32)
    prev_pts = rng.uniform(0, 60, (3, 17, 3)).astype(np.float32)
    prev_pts[..., :2] += prev_boxes[:, None, :2]
    boxes = np.array([[101, 21, 161, 141], [12, 9, 61, 121],
                      [300, 300, 360, 420], [203, 38, 240, 112]], np.float32)
    pts = np.stack([prev_pts[1] + 1.5, prev_pts[0] - 2.0,
                    rng.uniform(300, 400, (17, 3)),
                    prev_pts[2] + 0.5]).astype(np.float32)
    pts[3, 4, :2] += 200.0  # one outlier joint
    return boxes, pts, prev_boxes, prev_pts, np.array([7, 3, 5], np.int32)


def test_tracking_matches_jax(scene):
    boxes, pts, prev_boxes, prev_pts, prev_ids = scene
    np.testing.assert_array_equal(TT.COCO_SIGMAS, JT.COCO_SIGMAS)
    e_filtered = TT.oks_iou_yx(pts[3], prev_pts[2:3], 2000.0,
                               np.array([2000.0]))
    np.testing.assert_array_equal(
        e_filtered, JT.oks_iou_yx(pts[3], prev_pts[2:3], 2000.0,
                                  np.array([2000.0])))
    for vis in (None, 0.5):
        np.testing.assert_array_equal(
            TT.oks_iou_yx(pts[0], prev_pts, 900.0, np.full(3, 800.0),
                          in_vis_thre=vis),
            JT.oks_iou_yx(pts[0], prev_pts, 900.0, np.full(3, 800.0),
                          in_vis_thre=vis))
    for kw in (dict(), dict(pose_alpha=0.2, similarity_threshold=0.4,
                            smoothing_alpha=0.1)):
        got = TT.find_person_id_associations(
            boxes, pts, prev_boxes, prev_pts, prev_ids, next_person_id=10,
            **kw)
        want = JT.find_person_id_associations(
            boxes, pts, prev_boxes, prev_pts, prev_ids, next_person_id=10,
            **kw)
        np.testing.assert_array_equal(got[2], want[2])
        assert list(got[2][:2]) == [3, 7]
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_drawing_is_bitwise_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (120, 90, 3)).astype(np.uint8)
    pts = np.zeros((17, 3), np.float32)
    pts[:, 0] = rng.uniform(5, 115, 17)
    pts[:, 1] = rng.uniform(5, 85, 17)
    pts[:, 2] = rng.uniform(0, 1, 17)
    for kw in (dict(), dict(person_index=3, points_color_palette='gist_rainbow',
                            skeleton_color_palette='jet',
                            points_palette_samples=10)):
        np.testing.assert_array_equal(
            TV.draw_points_and_skeleton(img.copy(), pts, **kw),
            JV.draw_points_and_skeleton(img.copy(), pts, **kw))
    mpii = pts[:16]
    np.testing.assert_array_equal(
        TV.draw_points_and_skeleton(img.copy(), mpii, TV.MPII_SKELETON),
        JV.draw_points_and_skeleton(img.copy(), mpii, JV.MPII_SKELETON))
    args = (rng.standard_normal((3, 16, 12, 3)).astype(np.float32),
            None, rng.uniform(0, 3, (3, 17, 2)), None,
            rng.uniform(0, 3, (3, 17, 2)), rng.uniform(0, 1, (3, 17, 1)))
    for a, b in zip(TV.save_images(*args), JV.save_images(*args)):
        np.testing.assert_array_equal(a, b)
    missing = str(tmp_path / 'none.avi')
    assert TV.check_video_rotation(missing) == \
        JV.check_video_rotation(missing)


def test_prefetch_keeps_order_and_reraises():
    assert list(TP.prefetch_iter(range(50), depth=3)) == list(range(50))

    def broken():
        yield 1
        yield 2
        raise KeyError('decode failed')

    it = TP.prefetch_iter(broken())
    assert [next(it), next(it)] == [1, 2]
    with pytest.raises(KeyError, match='decode failed'):
        next(it)
    assert list(JP.prefetch_iter(range(5))) == list(TP.prefetch_iter(
        range(5)))


@pytest.fixture(scope='module')
def video(tmp_path_factory):
    """A 4-frame 64x64 MJPG video written by cv2, and a W8 checkpoint."""
    import cv2

    d = tmp_path_factory.mktemp('cli')
    path = str(d / 'in.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 10,
                             (64, 64))
    rng = np.random.default_rng(2)
    for _ in range(4):
        writer.write(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))
    writer.release()
    ckpt = str(d / 'w8.pth')
    torch.save(TH.init(8, 17, seed=0).state_dict(), ckpt)
    return d, path, ckpt


def _read_csv(path):
    with open(path) as f:
        return np.asarray([[float(v) for v in row] for row in csv.reader(f)])


def test_extract_keypoints_matches_jax_cli(video):
    """Single person: the port's CSV and JSON against the JAX CLI's on the
    same video; multi-person (random YOLOv3-tiny, through the chunked
    stream): the formats."""
    d, path, ckpt = video
    kw = dict(filename=path, hrnet_c=8, hrnet_weights=ckpt,
              image_resolution=str(RES), single_person=True)
    out = {}
    for tag, main, dev in (('port', TK.main, {'device': 'cpu'}),
                           ('jax', JK.main, {})):
        for fmt in ('csv', 'json'):
            out[tag, fmt] = str(d / f'{tag}.{fmt}')
            main(format=fmt, csv_output_filename=out[tag, 'csv'],
                 json_output_filename=str(d / f'{tag}.json'), **kw, **dev)
    port, ref = _read_csv(out['port', 'csv']), _read_csv(out['jax', 'csv'])
    assert port.shape == ref.shape == (4, 2 + 17 * 3)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4)
    with open(out['port', 'json']) as f, open(out['jax', 'json']) as g:
        pj, rj = json.load(f), json.load(g)
    assert sorted(pj) == sorted(rj) == ['0', '1', '2', '3']
    for k in pj:
        np.testing.assert_allclose(pj[k], rj[k], rtol=0, atol=1e-4)

    multi = str(d / 'multi.csv')
    TK.main(format='csv', filename=path, hrnet_c=8, hrnet_weights=ckpt,
            image_resolution=str(RES), use_tiny_yolo=True, max_batch_size=4,
            csv_output_filename=multi, device='cpu', pipeline=True,
            batch_frames=2)
    rows = _read_csv(multi)
    assert rows.shape[1] == 2 + 17 * 3 and len(rows) > 0
    assert set(rows[:, 0]) <= {0, 1, 2, 3}
    assert np.isfinite(rows).all()


def test_live_demo_loop(video, monkeypatch):
    """The demo on the video: shown (imshow/waitKey patched) with tracking
    through the per-frame stream, then saved to output.avi."""
    import cv2

    d, path, ckpt = video
    shown = []
    monkeypatch.setattr(cv2, 'imshow', lambda name, f: shown.append(f.shape))
    monkeypatch.setattr(cv2, 'waitKey', lambda ms: -1)
    monkeypatch.chdir(d)
    kw = dict(filename=path, hrnet_c=8, hrnet_weights=ckpt,
              image_resolution=str(RES), use_tiny_yolo=True,
              max_batch_size=4, device='cpu')
    TL.main(pipeline=True, **kw)
    assert shown == [(64, 64, 3)] * 4
    TL.main(save_video=True, disable_tracking=True, **kw)
    saved = cv2.VideoCapture(str(d / 'output.avi'))
    n = 0
    while saved.read()[0]:
        n += 1
    saved.release()
    assert n == 4 and len(shown) == 4

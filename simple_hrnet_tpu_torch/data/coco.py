"""COCO keypoint dataset: the host pipeline that feeds the train step.

Counterpart of ``simple_hrnet_tpu/data/coco.py`` (reference
datasets/COCO.py:22-599), with the same per-item semantics: bbox
sanitization, box -> center/scale (pixel_std 200, 1.25 inflation),
half-body / scale / rotation / flip augmentation drawn from Python's
``random`` in the same order, the cv2 warpAffine to the input size,
ImageNet normalization (subtract-then-multiply with the shared f32
constants), gaussian heatmap targets and per-joint weights, and PCK and
COCO-AP evaluation (OKS rescoring, ``oks_nms`` / ``soft_oks_nms``).

Items are NHWC numpy arrays (image HWC f32, target (h, w, J)); the train
step moves them to the device. ``cv2`` is imported inside the two methods
that read and warp an image (``_read_image``, ``_warp``), which a dataset
of in-memory images may override. ``use_native_decode=True`` reads each
JPEG with the host library of ``data/native.py`` instead: one C call
decodes, warps (the flip folded into the map) and normalizes (JAX
coco.py:100-107, 203-216, 269-281).
"""

from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import List

import numpy as np

from simple_hrnet_tpu_torch.data import target as target_gen
from simple_hrnet_tpu_torch.data.base import HumanPoseEstimationDataset
from simple_hrnet_tpu_torch.data.coco_io import COCOAnnotations
from simple_hrnet_tpu_torch.ops import affine
from simple_hrnet_tpu_torch.ops import nms as nms_ops
from simple_hrnet_tpu_torch.ops.image import INV255_STD, MEAN255

__all__ = ['COCODataset', 'fliplr_joints', 'INV255_STD', 'MEAN255']

# the native decode's normalize constants for the raw device_targets tail
_RAW_MEAN = np.zeros(3, np.float32)
_RAW_SCALE = np.ones(3, np.float32)


def fliplr_joints(joints, joints_vis, width, matched_parts):
    """Horizontal joint flip (reference misc/utils.py:32-43)."""
    joints[:, 0] = width - joints[:, 0] - 1
    for pair in matched_parts:
        joints[pair[0], :], joints[pair[1], :] = \
            joints[pair[1], :], joints[pair[0], :].copy()
        joints_vis[pair[0], :], joints_vis[pair[1], :] = \
            joints_vis[pair[1], :], joints_vis[pair[0], :].copy()
    return joints * joints_vis, joints_vis


class COCODataset(HumanPoseEstimationDataset):
    """The reference COCODataset's constructor surface (COCO.py:27-32)."""

    def __init__(self,
                 root_path: str = './datasets/COCO',
                 data_version: str = 'train2017',
                 is_train: bool = True,
                 use_gt_bboxes: bool = True,
                 bbox_path: str = '',
                 image_width: int = 288,
                 image_height: int = 384,
                 color_rgb: bool = True,
                 scale: bool = True,
                 scale_factor: float = 0.35,
                 flip_prob: float = 0.5,
                 rotate_prob: float = 0.5,
                 rotation_factor: float = 45.,
                 half_body_prob: float = 0.3,
                 use_different_joints_weight: bool = False,
                 heatmap_sigma: float = 3,
                 soft_nms: bool = False,
                 use_native_decode: bool = False,
                 device_targets: bool = False):
        self.root_path = root_path
        self.data_version = data_version
        self.is_train = is_train
        self.use_gt_bboxes = use_gt_bboxes
        self.bbox_path = bbox_path
        self.image_width = image_width
        self.image_height = image_height
        self.color_rgb = color_rgb
        self.scale = scale
        self.scale_factor = scale_factor
        self.flip_prob = flip_prob
        self.rotate_prob = rotate_prob
        self.rotation_factor = rotation_factor
        self.half_body_prob = half_body_prob
        self.use_different_joints_weight = use_different_joints_weight
        self.heatmap_sigma = heatmap_sigma
        self.soft_nms = soft_nms
        # the fused native JPEG -> warp -> normalize path (data/native.py):
        # built here, so that a missing toolchain or jpeglib.h raises now
        if use_native_decode:
            from simple_hrnet_tpu_torch.data import native as native_img
            native_img._load()
        self.use_native_decode = use_native_decode
        # device_targets: __getitem__ stops at the warp and returns the raw
        # [0, 255] image with the transformed joints; the train step
        # normalizes and stamps the targets on the device
        # (train/steps.py:_batch_inputs)
        self.device_targets = device_targets

        self.data_path = os.path.join(root_path, data_version)
        self.annotation_path = os.path.join(
            root_path, 'annotations', f'person_keypoints_{data_version}.json')

        self.image_size = (image_width, image_height)
        self.aspect_ratio = image_width / image_height
        self.heatmap_size = (image_width // 4, image_height // 4)
        self.heatmap_type = 'gaussian'
        self.pixel_std = 200

        self.nof_joints = 17
        self.nof_joints_half_body = 8
        self.flip_pairs = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10],
                           [11, 12], [13, 14], [15, 16]]
        self.upper_body_ids = list(range(11))
        self.lower_body_ids = list(range(11, 17))
        self.joints_weight = target_gen.COCO_JOINTS_WEIGHT

        self.coco = COCOAnnotations(self.annotation_path)

        bboxes = None
        if not use_gt_bboxes:
            import pickle
            with open(bbox_path, 'rb') as fd:
                bboxes = pickle.load(fd)

        self.data: List[dict] = []
        for img_id in self.coco.get_img_ids():
            img = self.coco.load_imgs(img_id)

            if use_gt_bboxes:
                objs = []
                for obj in self.coco.load_anns(img_id, iscrowd=False):
                    if obj['category_id'] != 1:
                        continue
                    if max(obj['keypoints']) == 0:
                        continue
                    x, y, w, h = obj['bbox']
                    x1 = max(0, x)
                    y1 = max(0, y)
                    x2 = min(img['width'] - 1, x1 + max(0, w - 1))
                    y2 = min(img['height'] - 1, y1 + max(0, h - 1))
                    if obj['area'] > 0 and x2 >= x1 and y2 >= y1:
                        obj = dict(obj)
                        obj['clean_bbox'] = [x1, y1, x2 - x1, y2 - y1]
                        objs.append(obj)
            else:
                objs = bboxes[img_id]

            for obj in objs:
                joints = np.zeros((self.nof_joints, 2), np.float64)
                joints_visibility = np.ones((self.nof_joints, 2), np.float64)
                if use_gt_bboxes:
                    for pt in range(self.nof_joints):
                        joints[pt, 0] = obj['keypoints'][pt * 3 + 0]
                        joints[pt, 1] = obj['keypoints'][pt * 3 + 1]
                        t_vis = int(np.clip(obj['keypoints'][pt * 3 + 2],
                                            0, 1))
                        joints_visibility[pt, 0] = t_vis
                        joints_visibility[pt, 1] = t_vis
                center, scale_cs = self._box2cs(obj['clean_bbox'][:4])
                self.data.append({
                    'imgId': img_id,
                    'annId': obj['id'],
                    'imgPath': os.path.join(root_path, data_version,
                                            '%012d.jpg' % img_id),
                    'center': center,
                    'scale': scale_cs,
                    'joints': joints,
                    'joints_visibility': joints_visibility,
                })

        # eval thresholds (COCO.py:233-238)
        self.bbox_thre = 1.0
        self.image_thre = 0.0
        self.in_vis_thre = 0.2
        self.nms_thre = 1.0
        self.oks_thre = 0.9

    def __len__(self):
        return len(self.data)

    def _read_image(self, path: str) -> np.ndarray:
        """The image at ``path`` as HWC uint8, RGB when ``color_rgb``."""
        import cv2

        image = cv2.imread(path,
                           cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if image is None:
            raise ValueError('Fail to read %s' % path)
        if self.color_rgb:
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        return image

    def _warp(self, image: np.ndarray, trans: np.ndarray) -> np.ndarray:
        """cv2.warpAffine of ``image`` by ``trans`` to the input size."""
        import cv2

        return cv2.warpAffine(
            image, trans, (int(self.image_size[0]), int(self.image_size[1])),
            flags=cv2.INTER_LINEAR)

    def __getitem__(self, index: int):
        """One (image HWC f32, target (h,w,J), target_weight (J,1), meta),
        or with ``device_targets`` (raw [0, 255] image, joints (J, 2),
        joints_vis (J, 2), meta)."""
        joints_data = dict(self.data[index])
        jpeg_bytes = None
        image = None
        fused_hw = None  # (img_w, img_h): fused native path, image undecoded
        if self.use_native_decode:
            from simple_hrnet_tpu_torch.data import native as native_img
            with open(joints_data['imgPath'], 'rb') as f:
                jpeg_bytes = f.read()
            dims = native_img.jpeg_dims(jpeg_bytes) if self.color_rgb \
                else None
            if dims is not None:
                # one C call makes the network-ready array; the flip folds
                # into the warp map
                fused_hw = dims
            else:
                image = native_img.decode_jpeg_rgb(jpeg_bytes)
                if image is None:
                    raise ValueError('Fail to read %s'
                                     % joints_data['imgPath'])
                if not self.color_rgb:
                    image = image[..., ::-1]
        else:
            image = self._read_image(joints_data['imgPath'])

        joints = joints_data['joints'].copy()
        joints_vis = joints_data['joints_visibility'].copy()
        c = np.asarray(joints_data['center'], np.float32).copy()
        s = np.asarray(joints_data['scale'], np.float32).copy()
        score = joints_data.get('score', 1)
        r = 0

        if self.is_train:
            if (self.half_body_prob and
                    random.random() < self.half_body_prob and
                    np.sum(joints_vis[:, 0]) > self.nof_joints_half_body):
                c_hb, s_hb = self._half_body_transform(joints, joints_vis)
                if c_hb is not None and s_hb is not None:
                    c, s = c_hb, s_hb

            if self.scale:
                sf = self.scale_factor
                s = s * np.clip(random.random() * sf + 1, 1 - sf, 1 + sf)
            if self.rotate_prob and random.random() < self.rotate_prob:
                rf = self.rotation_factor
                r = np.clip(random.random() * rf, -rf * 2, rf * 2)
            else:
                r = 0
            if self.flip_prob and random.random() < self.flip_prob:
                img_w = fused_hw[0] if fused_hw is not None \
                    else image.shape[1]
                flipped = True
                if fused_hw is None:
                    image = image[:, ::-1, :]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, img_w, self.flip_pairs)
                c[0] = img_w - c[0] - 1
            else:
                flipped = False
        else:
            flipped = False

        trans = affine.affine_matrix(c, s, r, self.image_size,
                                     self.pixel_std)
        if fused_hw is not None:
            from simple_hrnet_tpu_torch.data import native as native_img
            m_inv = affine.affine_matrix(c, s, r, self.image_size,
                                         self.pixel_std, inv=True)
            if flipped:
                # the horizontal flip in the dst -> src map:
                # src_x_original = (W - 1) - src_x_flipped
                m_inv = np.stack([
                    np.asarray([-m_inv[0, 0], -m_inv[0, 1],
                                fused_hw[0] - 1 - m_inv[0, 2]], np.float32),
                    m_inv[1].astype(np.float32)])
            mean, scale = (_RAW_MEAN, _RAW_SCALE) if self.device_targets \
                else (MEAN255, INV255_STD)
            image = native_img.decode_warp_normalize(
                jpeg_bytes, m_inv, int(self.image_size[1]),
                int(self.image_size[0]), mean, scale)
            if image is None:
                raise ValueError('Fail to read %s' % joints_data['imgPath'])
        else:
            image = self._warp(image, trans)
            if self.device_targets:
                # the step's (x - MEAN255) * INV255_STD consumes this raw
                # tail: bit for bit the host normalize below
                image = image.astype(np.float32)
            else:
                image = (image.astype(np.float32) - MEAN255) * INV255_STD

        for i in range(self.nof_joints):
            if joints_vis[i, 0] > 0.:
                joints[i, 0:2] = affine.apply_affine(joints[i, 0:2], trans)

        joints_data['joints'] = joints
        joints_data['joints_visibility'] = joints_vis
        joints_data['center'] = c
        joints_data['scale'] = s
        joints_data['rotation'] = r
        joints_data['score'] = score

        if self.device_targets:
            # raw pipeline tail: targets are stamped in-graph by the step
            return (image, joints.astype(np.float32),
                    joints_vis.astype(np.float32), joints_data)

        target, target_weight = target_gen.generate_target(
            joints, joints_vis, self.heatmap_size, self.image_size,
            self.heatmap_sigma,
            self.joints_weight if self.use_different_joints_weight else None)

        # NHWC: target (J, h, w) -> (h, w, J)
        return (image, np.transpose(target, (1, 2, 0)).astype(np.float32),
                target_weight.astype(np.float32), joints_data)

    # -- evaluation ---------------------------------------------------------

    # evaluate_accuracy (PCK, reference COCO.py:318-326) is inherited
    # from HumanPoseEstimationDataset (data/base.py)

    def evaluate_overall_accuracy(self, predictions, bounding_boxes,
                                  image_paths, output_dir, rank=0.):
        """OKS rescoring + oks_nms + COCO AP (reference COCO.py:328-390)."""
        import json

        res_folder = os.path.join(output_dir, 'results')
        os.makedirs(res_folder, exist_ok=True)
        res_file = os.path.join(
            res_folder,
            f'keypoints_{self.data_version}_results_{rank}.json')

        _kpts = []
        for idx, kpt in enumerate(predictions):
            _kpts.append({
                'keypoints': kpt,
                'center': bounding_boxes[idx][0:2],
                'scale': bounding_boxes[idx][2:4],
                'area': bounding_boxes[idx][4],
                'score': bounding_boxes[idx][5],
                'image': int(str(image_paths[idx])[-16:-4]),
            })
        kpts = defaultdict(list)
        for kpt in _kpts:
            kpts[kpt['image']].append(kpt)

        oks_nmsed_kpts = []
        for img in kpts.keys():
            img_kpts = kpts[img]
            for n_p in img_kpts:
                box_score = n_p['score']
                kpt_score = 0
                valid_num = 0
                for n_jt in range(self.nof_joints):
                    t_s = n_p['keypoints'][n_jt][2]
                    if t_s > self.in_vis_thre:
                        kpt_score += t_s
                        valid_num += 1
                if valid_num != 0:
                    kpt_score = kpt_score / valid_num
                n_p['score'] = kpt_score * box_score
            if self.soft_nms:
                keep = nms_ops.soft_oks_nms(img_kpts, self.oks_thre)
            else:
                keep = nms_ops.oks_nms(img_kpts, self.oks_thre)
            if len(keep) == 0:
                oks_nmsed_kpts.append(img_kpts)
            else:
                oks_nmsed_kpts.append([img_kpts[k] for k in keep])

        # write results in COCO format + evaluate
        results = []
        for img_kpts in oks_nmsed_kpts:
            for k in img_kpts:
                kp = np.asarray(k['keypoints'], np.float64)
                results.append({
                    'image_id': k['image'],
                    'category_id': 1,
                    'keypoints': kp.flatten().tolist(),
                    'score': float(k['score']),
                    'center': list(np.asarray(k['center'], np.float64)),
                    'scale': list(np.asarray(k['scale'], np.float64)),
                })
        with open(res_file, 'w') as f:
            json.dump(results, f, sort_keys=True, indent=4)

        if 'test' not in self.data_version:
            from simple_hrnet_tpu_torch.utils import metrics
            stats = metrics.coco_eval_from_results(self.coco.raw, results)
            return stats, stats['AP']
        return {'Null': 0}, 0

    # -- private (reference COCO.py:394-458) --------------------------------

    def _box2cs(self, box):
        x, y, w, h = box[:4]
        return self._xywh2cs(x, y, w, h)

    def _xywh2cs(self, x, y, w, h):
        center = np.asarray([x + w * 0.5, y + h * 0.5], np.float32)
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.asarray([w / self.pixel_std, h / self.pixel_std],
                           np.float32)
        if center[0] != -1:
            scale = scale * 1.25
        return center, scale

    def _half_body_transform(self, joints, joints_vis):
        upper, lower = [], []
        for jid in range(self.nof_joints):
            if joints_vis[jid][0] > 0:
                (upper if jid in self.upper_body_ids else lower).append(
                    joints[jid])
        if random.random() < 0.5 and len(upper) > 2:
            selected = upper
        else:
            selected = lower if len(lower) > 2 else upper
        if len(selected) < 2:
            return None, None
        selected = np.asarray(selected, np.float32)
        center = selected.mean(axis=0)[:2]
        left_top = np.amin(selected, axis=0)
        right_bottom = np.amax(selected, axis=0)
        w = right_bottom[0] - left_top[0]
        h = right_bottom[1] - left_top[1]
        if w > self.aspect_ratio * h:
            h = w / self.aspect_ratio
        elif w < self.aspect_ratio * h:
            w = h * self.aspect_ratio
        scale = np.asarray([w / self.pixel_std, h / self.pixel_std],
                           np.float32) * 1.5
        return center, scale

"""MPII single-person keypoint dataset (16 joints).

Counterpart of ``simple_hrnet_tpu/data/mpii.py``, over the port's
``data/target.py``, ``data/base.py``, ``ops/affine.py`` and ``data/coco.py``
(``fliplr_joints``, ``MEAN255``, ``INV255_STD``), with the JAX module's
item arithmetic and public names. As in the port's ``COCODataset``,
``cv2`` is imported inside the two methods that read and warp an image
(``_read_image``, ``_warp``), which a dataset of in-memory images may
override.

Capability beyond the reference: simple-HRNet ships only COCO + LiveCamera
datasets (reference datasets/, SURVEY.md §2.1), yet its inference facade and
visualization already speak MPII (16-joint skeletons/names,
misc/visualization.py:41-66) because the official HRNet releases
``pose_hrnet_*_mpii`` checkpoints. This module closes the loop so those
models can be TRAINED and evaluated here too.

Annotation format: the standard ``annot/{train,valid,test}.json`` files of
the official HRNet / SimpleBaselines releases — a list of records
``{image, center [x,y], scale s, joints (16,2), joints_vis (16,)}`` with
MATLAB 1-based coordinates. The loading arithmetic (center -1 shift, the
``center.y += 15*scale`` torso lift, the 1.25 scale inflation) follows the
official release's ``lib/dataset/mpii.py`` so items are pixel-identical to
what those checkpoints were trained on.

Evaluation: PCKh@0.5 — joint is correct within 0.5 x head size, where head
size is the 0.6-biased head-segment length (SC_BIAS) from headboxes when
provided, else from the head-top/upper-neck joint pair.

Same output protocol as COCODataset: (image HWC f32 normalized,
target (h, w, J), target_weight (J, 1), meta).
"""

from __future__ import annotations

import json
import os
import random
from typing import List

import numpy as np

from simple_hrnet_tpu_torch.data import target as target_gen
from simple_hrnet_tpu_torch.data.base import HumanPoseEstimationDataset
from simple_hrnet_tpu_torch.data.coco import (INV255_STD, MEAN255,
                                              fliplr_joints)
from simple_hrnet_tpu_torch.ops import affine

# joint order (official MPII): 0-r_ankle 1-r_knee 2-r_hip 3-l_hip 4-l_knee
# 5-l_ankle 6-pelvis 7-thorax 8-upper_neck 9-head_top 10-r_wrist 11-r_elbow
# 12-r_shoulder 13-l_shoulder 14-l_elbow 15-l_wrist
MPII_FLIP_PAIRS = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
MPII_UPPER_BODY_IDS = (7, 8, 9, 10, 11, 12, 13, 14, 15)
MPII_LOWER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6)
HEAD_TOP, UPPER_NECK = 9, 8
SC_BIAS = 0.6  # official MPII eval head-size bias


class MPIIDataset(HumanPoseEstimationDataset):
    """MPII dataset with the COCODataset item protocol (16 joints)."""

    def __init__(self,
                 root_path: str = './datasets/MPII',
                 data_version: str = 'train',
                 is_train: bool = True,
                 image_width: int = 288,
                 image_height: int = 384,
                 color_rgb: bool = True,
                 scale: bool = True,
                 scale_factor: float = 0.25,
                 flip_prob: float = 0.5,
                 rotate_prob: float = 0.5,
                 rotation_factor: float = 30.,
                 half_body_prob: float = 0.0,
                 use_different_joints_weight: bool = False,
                 heatmap_sigma: float = 3,
                 device_targets: bool = False):
        self.root_path = root_path
        self.data_version = data_version
        self.is_train = is_train
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
        # see data/coco.py: normalize + targets move into the train step
        self.device_targets = device_targets

        self.image_size = (image_width, image_height)
        self.aspect_ratio = image_width / image_height
        self.heatmap_size = (image_width // 4, image_height // 4)
        self.pixel_std = 200

        self.nof_joints = 16
        self.nof_joints_half_body = 8
        self.flip_pairs = [list(p) for p in MPII_FLIP_PAIRS]
        self.upper_body_ids = list(MPII_UPPER_BODY_IDS)
        self.lower_body_ids = list(MPII_LOWER_BODY_IDS)
        # MPII weighs wrists/ankles up like COCO's scheme; official release
        # uses uniform weights for MPII — keep uniform unless asked
        self.joints_weight = np.ones((16, 1), np.float32)

        self.annotation_path = os.path.join(root_path, 'annot',
                                            f'{data_version}.json')
        with open(self.annotation_path) as f:
            annots = json.load(f)

        self.data: List[dict] = []
        for a in annots:
            c = np.asarray(a['center'], np.float32)
            s = np.asarray([a['scale'], a['scale']], np.float32)
            if c[0] != -1:
                # official mpii.py: lift the center to compensate for the
                # annotation's head-centric bias, then inflate
                c[1] = c[1] + 15 * s[1]
                s = s * 1.25
            c = c - 1  # MATLAB 1-based -> 0-based

            joints = np.asarray(a.get('joints',
                                      np.zeros((16, 2))), np.float64)
            if joints.size:
                joints = joints - 1
            vis = np.asarray(a.get('joints_vis', np.ones(16)), np.float64)
            joints_visibility = np.stack([vis, vis], axis=1)

            self.data.append({
                'imgPath': os.path.join(root_path, 'images', a['image']),
                'image': a['image'],
                'center': c,
                'scale': s,
                'joints': joints,
                'joints_visibility': joints_visibility,
                'headbox': a.get('headbox'),
            })

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
        joints_data = dict(self.data[index])
        # dataset row id, so PCKh evaluation can match predictions to THEIR
        # annotations even off a shuffled loader (MPIITrain collects these)
        joints_data['index'] = index
        image = self._read_image(joints_data['imgPath'])

        joints = joints_data['joints'].copy()
        joints_vis = joints_data['joints_visibility'].copy()
        c = np.asarray(joints_data['center'], np.float32).copy()
        s = np.asarray(joints_data['scale'], np.float32).copy()
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
            if self.flip_prob and random.random() < self.flip_prob:
                image = image[:, ::-1, :]
                joints, joints_vis = fliplr_joints(
                    joints, joints_vis, image.shape[1], self.flip_pairs)
                c[0] = image.shape[1] - c[0] - 1

        trans = affine.affine_matrix(c, s, r, self.image_size, self.pixel_std)
        image = self._warp(image, trans)
        if self.device_targets:
            # raw [0, 255] tail; normalize runs in-graph (ops/image.py)
            image = image.astype(np.float32)
        else:
            image = ((image.astype(np.float32) - MEAN255) * INV255_STD)

        for i in range(self.nof_joints):
            if joints_vis[i, 0] > 0.:
                joints[i, 0:2] = affine.apply_affine(joints[i, 0:2], trans)

        joints_data['joints'] = joints
        joints_data['joints_visibility'] = joints_vis
        joints_data['center'] = c
        joints_data['scale'] = s
        joints_data['rotation'] = r
        joints_data['score'] = 1

        if self.device_targets:
            # raw pipeline tail: targets are stamped in-graph by the step
            return (image, joints.astype(np.float32),
                    joints_vis.astype(np.float32), joints_data)

        target, target_weight = target_gen.generate_target(
            joints, joints_vis, self.heatmap_size, self.image_size,
            self.heatmap_sigma,
            self.joints_weight if self.use_different_joints_weight else None)

        return (image, np.transpose(target, (1, 2, 0)).astype(np.float32),
                target_weight.astype(np.float32), joints_data)

    # -- evaluation ----------------------------------------------------------

    def evaluate_overall_accuracy(self, predictions, bounding_boxes,
                                  image_paths, output_dir, rank=0.,
                                  indices=None):
        """PCKh@0.5 over final (original-coordinate) predictions.

        Same call signature as COCODataset.evaluate_overall_accuracy so the
        COCOTrain-style harness works unchanged; returns (per-joint +
        aggregate dict, mean PCKh) instead of AP. ``indices`` gives each
        prediction's dataset row (MPIITrain collects them from the batches'
        joints_data['index']); without it predictions are matched
        positionally, which is only valid off an order-preserving
        (non-shuffled, non-drop_last) loader.
        """
        from simple_hrnet_tpu_torch.utils import metrics

        preds = np.asarray(predictions)[..., :2]  # (N, 16, (x, y))
        if indices is not None:
            rows = [self.data[int(i)] for i in indices]
        else:
            rows = self.data[:len(preds)]
        gts = np.stack([d['joints'] for d in rows])
        vis = np.stack([d['joints_visibility'][:, 0] for d in rows])
        heads = np.asarray([self.head_size(d) for d in rows])
        stats = metrics.evaluate_pckh(preds, gts, vis, heads)
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir,
                               f'pckh_{self.data_version}_{rank}.json'),
                  'w') as f:
            json.dump({k: float(v) for k, v in stats.items()}, f, indent=2)
        return stats, stats['Mean']

    def head_size(self, record: dict) -> float:
        """Head size for PCKh: SC_BIAS * headbox diagonal when annotated,
        else SC_BIAS-free fallback from the head segment joints."""
        hb = record.get('headbox')
        if hb is not None:
            hb = np.asarray(hb, np.float64)
            return float(SC_BIAS * np.linalg.norm(hb[2:4] - hb[0:2]))
        j = record['joints']
        seg = np.linalg.norm(j[HEAD_TOP] - j[UPPER_NECK])
        return float(max(seg, 1.0))

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

"""Minimal COCO keypoint annotation reader (stdlib json).

Counterpart of ``simple_hrnet_tpu/data/coco_io.py``: it takes the place of
pycocotools for loading (reference datasets/COCO.py:127) with the images
index, the per-image person annotations and the raw dict the evaluator
reads.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class COCOAnnotations:
    """Parsed person_keypoints_*.json with the lookups the dataset needs."""

    def __init__(self, annotation_path: str):
        with open(annotation_path) as f:
            self.raw = json.load(f)
        self.imgs: Dict[int, dict] = {im['id']: im
                                      for im in self.raw.get('images', [])}
        self.img_anns: Dict[int, List[dict]] = defaultdict(list)
        for ann in self.raw.get('annotations', []):
            self.img_anns[ann['image_id']].append(ann)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_imgs(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns(self, img_id: int, iscrowd: bool = False) -> List[dict]:
        anns = self.img_anns.get(img_id, [])
        if not iscrowd:
            anns = [a for a in anns if not a.get('iscrowd', 0)]
        return anns

"""Live camera / video dataset (reference datasets/LiveCamera.py:9-83).

Counterpart of ``simple_hrnet_tpu/data/live.py``: host code on ``cv2``
(imported inside the methods that use it); a ``detector`` is any object
with the port detectors' ``predict_single`` (YOLOv3 or YOLOv5).

Iterable frame source wrapping cv2.VideoCapture with optional on-the-fly
person detection. The reference's version swaps H/W when resizing
(LiveCamera.py:37,62,75 use resolution[1], resolution[0] against
SimpleHRNet's (height, width) convention); here ``resolution`` is
consistently (height, width) — the deviation is deliberate and documented.
"""

from __future__ import annotations

from typing import Optional, Tuple


class LiveCameraDataset:
    def __init__(self, camera_id: int = 0, filename: Optional[str] = None,
                 resolution: Optional[Tuple[int, int]] = None,
                 detector=None, max_frames: Optional[int] = None,
                 rotation_code: Optional[int] = None):
        import cv2

        self.camera_id = camera_id
        self.filename = filename
        self.resolution = resolution  # (height, width) or None
        self.detector = detector
        self.max_frames = max_frames
        self.rotation_code = rotation_code
        self.capture = cv2.VideoCapture(
            filename if filename is not None else camera_id)
        self.frame_count = 0

    def __len__(self):
        return self.max_frames if self.max_frames is not None else 2 ** 31

    def __iter__(self):
        return self

    def __next__(self):
        import cv2

        if self.max_frames is not None and self.frame_count >= self.max_frames:
            raise StopIteration
        ok, frame = self.capture.read()
        if not ok:
            raise StopIteration
        self.frame_count += 1
        if self.rotation_code is not None:
            frame = cv2.rotate(frame, self.rotation_code)
        if self.resolution is not None:
            frame = cv2.resize(frame,
                               (self.resolution[1], self.resolution[0]))
        if self.detector is not None:
            detections = self.detector.predict_single(frame)
            return ok, frame, detections
        return ok, frame

    def release(self):
        self.capture.release()

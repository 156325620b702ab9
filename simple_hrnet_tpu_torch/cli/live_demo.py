"""Live webcam/video demo with the port's facade (the JAX package's
``cli/live_demo.py``; reference scripts/live-demo.py:17-218).

Reads frames from a camera or video, runs multi-person pose estimation,
tracks person identities over time, draws skeletons and shows/saves frames.
Same flags as the JAX package's; ``vidgear`` is optional. ``--device`` is
'cuda' unless 'cpu' is asked for.

    python -m simple_hrnet_tpu_torch.cli.live_demo -f video.mp4 --save_video
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np


def main(camera_id=0, filename=None, hrnet_m='HRNet', hrnet_c=48, hrnet_j=17,
         hrnet_weights='./weights/pose_hrnet_w48_384x288.pth',
         hrnet_joints_set='coco', image_resolution='(384, 288)',
         single_person=False, yolo_version='v3', use_tiny_yolo=False,
         disable_tracking=False, max_batch_size=16, disable_vidgear=False,
         save_video=False, video_format='MJPG', video_framerate=30,
         device=None, enable_tensorrt=False, max_frames=None,
         pipeline=False, adaptive_slots=False):
    import cv2

    from simple_hrnet_tpu_torch import SimpleHRNet
    from simple_hrnet_tpu_torch.utils.tracking import find_person_id_associations
    from simple_hrnet_tpu_torch.utils.visualization import (
        COCO_SKELETON, MPII_SKELETON, check_video_rotation,
        draw_points_and_skeleton)

    skeleton = COCO_SKELETON if hrnet_joints_set == 'coco' else MPII_SKELETON
    if isinstance(image_resolution, str):
        image_resolution = ast.literal_eval(image_resolution)

    # camera source: vidgear CamGear when available and not disabled
    # (reference live-demo.py:41-45); files always use cv2.VideoCapture
    rotation_code = None
    video_source = None
    vidgear_stream = None
    if filename is not None:
        rotation_code = check_video_rotation(filename)
        video_source = cv2.VideoCapture(filename)
    elif not disable_vidgear:
        try:
            from vidgear.gears import CamGear
            vidgear_stream = CamGear(camera_id).start()
        except ImportError:  # vidgear not installed — plain capture
            video_source = cv2.VideoCapture(camera_id)
    else:
        video_source = cv2.VideoCapture(camera_id)

    yolo_model_def = ('yolov3-tiny' if use_tiny_yolo else 'yolov3')
    model = SimpleHRNet(
        hrnet_c, hrnet_j, hrnet_weights, model_name=hrnet_m,
        resolution=image_resolution, multiperson=not single_person,
        return_bounding_boxes=not disable_tracking,
        max_batch_size=max_batch_size, yolo_version=yolo_version,
        yolo_model_def=yolo_model_def, device=device,
        enable_tensorrt=enable_tensorrt,
        # the stream serves max_people=max_batch_size people slots; the
        # detector must be able to fill them
        yolo_max_detections=max(32, max_batch_size))

    video_writer = None
    prev_boxes = prev_pts = prev_person_ids = None
    next_person_id = 0

    def frame_gen():
        i = 0
        while max_frames is None or i < max_frames:
            if vidgear_stream is not None:
                f = vidgear_stream.read()
                ret = f is not None
            else:
                ret, f = video_source.read()
            if not ret:
                return
            if rotation_code is not None:
                f = cv2.rotate(f, rotation_code)
            yield f
            i += 1

    import collections
    frame_buf = collections.deque()

    def frames_tee():
        for f in frame_gen():
            frame_buf.append(f)
            yield f

    if pipeline and not single_person:
        # per-frame device pipeline + background frame decode; tracking
        # stays on the host, consuming results in frame order
        from simple_hrnet_tpu_torch.data.prefetch import prefetch_iter
        results = model.predict_stream(prefetch_iter(frames_tee()),
                                       max_people=max_batch_size,
                                       adaptive_slots=adaptive_slots)
    else:
        results = (model.predict(f) for f in frames_tee())

    t_start = time.time()
    for res in results:
        frame = frame_buf.popleft()

        if disable_tracking:
            pts = res
            boxes = None
        else:
            boxes, pts = res
            if prev_pts is None or prev_person_ids is None:
                person_ids = np.arange(next_person_id,
                                       len(pts) + next_person_id, dtype=np.int32)
                next_person_id = len(pts) + 1
            else:
                boxes, pts, person_ids = find_person_id_associations(
                    boxes=boxes, pts=pts, prev_boxes=prev_boxes,
                    prev_pts=prev_pts, prev_person_ids=prev_person_ids,
                    next_person_id=next_person_id, pose_alpha=0.2,
                    similarity_threshold=0.4, smoothing_alpha=0.1)
                next_person_id = max(next_person_id,
                                     int(np.max(person_ids)) + 1) \
                    if len(person_ids) else next_person_id
            prev_boxes = boxes
            prev_pts = pts
            prev_person_ids = person_ids

        if disable_tracking:
            person_ids = np.arange(len(pts), dtype=np.int32)
        for i, (pt, pid) in enumerate(zip(pts, person_ids)):
            frame = draw_points_and_skeleton(
                frame, pt, skeleton, person_index=pid,
                points_color_palette='gist_rainbow',
                skeleton_color_palette='jet',
                points_palette_samples=10)

        fps = 1.0 / max(time.time() - t_start, 1e-6)
        print(f'\rframerate: {fps:f} fps', end='')
        t_start = time.time()

        if save_video:
            if video_writer is None:
                fourcc = cv2.VideoWriter_fourcc(*video_format)
                video_writer = cv2.VideoWriter(
                    'output.avi', fourcc, video_framerate,
                    (frame.shape[1], frame.shape[0]))
            video_writer.write(frame)
        else:
            try:
                cv2.imshow('frame.png', frame)
                if cv2.waitKey(1) & 0xFF == ord('q'):
                    break
            except cv2.error:
                # headless environment — keep running (e.g. with save_video)
                pass

    if video_writer is not None:
        video_writer.release()
    if vidgear_stream is not None:
        vidgear_stream.stop()
    else:
        video_source.release()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--camera_id', '-d', type=int, default=0)
    parser.add_argument('--filename', '-f', type=str, default=None)
    parser.add_argument('--hrnet_m', '-m', type=str, default='HRNet')
    parser.add_argument('--hrnet_c', '-c', type=int, default=48)
    parser.add_argument('--hrnet_j', '-j', type=int, default=17)
    parser.add_argument('--hrnet_weights', '-w', type=str,
                        default='./weights/pose_hrnet_w48_384x288.pth')
    parser.add_argument('--hrnet_joints_set', type=str, default='coco')
    parser.add_argument('--image_resolution', '-r', type=str,
                        default='(384, 288)')
    parser.add_argument('--single_person', action='store_true')
    parser.add_argument('--yolo_version', type=str, default='v3')
    parser.add_argument('--use_tiny_yolo', action='store_true')
    parser.add_argument('--disable_tracking', action='store_true')
    parser.add_argument('--max_batch_size', type=int, default=16)
    parser.add_argument('--disable_vidgear', action='store_true')
    parser.add_argument('--save_video', action='store_true')
    parser.add_argument('--video_format', type=str, default='MJPG')
    parser.add_argument('--video_framerate', type=float, default=30)
    parser.add_argument('--device', type=str, default=None)
    parser.add_argument('--enable_tensorrt', action='store_true')
    parser.add_argument('--max_frames', type=int, default=None)
    parser.add_argument('--pipeline', action='store_true',
                        help='per-frame device pipeline + background '
                             'frame decode (multi-person)')
    parser.add_argument('--adaptive_slots', action='store_true',
                        help='with --pipeline: size the people-slot count '
                             'to the scene (max_batch_size becomes the '
                             'cap) — sparse scenes skip most of the pose '
                             'batch, crowded launches re-run one rung up')
    return parser


if __name__ == '__main__':
    main(**build_parser().parse_args().__dict__)

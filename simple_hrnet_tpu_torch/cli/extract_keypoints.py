"""Video -> keypoints CSV/JSON extraction with the port's facade (the JAX
package's ``cli/extract_keypoints.py``; reference
scripts/extract-keypoints.py:16-183). Same flags, defaults and output
formats: csv rows ``frame_index,detection_index,<y,x,conf>*J``; json
``{frame_index: [[y, x, conf] * J, ...]}``. ``--device`` is 'cuda' unless
'cpu' is asked for.

    python -m simple_hrnet_tpu_torch.cli.extract_keypoints -f video.mp4 \\
        --format csv --pipeline --batch_frames 8
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import time


def main(format=None, filename=None, hrnet_m='HRNet', hrnet_c=48, hrnet_j=17,
         hrnet_weights='./weights/pose_hrnet_w48_384x288.pth',
         image_resolution='(384, 288)', single_person=False,
         yolo_version='v3', use_tiny_yolo=False, max_batch_size=16,
         csv_output_filename='output.csv', csv_delimiter=',',
         json_output_filename='output.json', device=None,
         enable_tensorrt=False, max_frames=None, pipeline=False,
         batch_frames=1, adaptive_slots=False, compact_crops=False):
    import cv2

    from simple_hrnet_tpu_torch import SimpleHRNet
    from simple_hrnet_tpu_torch.utils.visualization import check_video_rotation

    if format is not None:
        format = format.lower()
    assert format in ('csv', 'json', None), 'format must be csv or json'

    rotation_code = check_video_rotation(filename) if filename else None
    video_source = cv2.VideoCapture(filename if filename else 0)

    yolo_model_def = 'yolov3-tiny' if use_tiny_yolo else 'yolov3'
    if isinstance(image_resolution, str):
        image_resolution = ast.literal_eval(image_resolution)

    model = SimpleHRNet(
        hrnet_c, hrnet_j, hrnet_weights, model_name=hrnet_m,
        resolution=image_resolution, multiperson=not single_person,
        max_batch_size=max_batch_size, yolo_version=yolo_version,
        yolo_model_def=yolo_model_def, device=device,
        enable_tensorrt=enable_tensorrt,
        # the stream serves max_people=max_batch_size people slots; the
        # detector must be able to fill them
        yolo_max_detections=max(32, max_batch_size))

    csv_file = csv_writer = None
    if format == 'csv':
        csv_file = open(csv_output_filename, 'w', newline='')
        csv_writer = csv.writer(csv_file, delimiter=csv_delimiter)
    json_data = {}

    def frames():
        i = 0
        while max_frames is None or i < max_frames:
            ret, frame = video_source.read()
            if not ret:
                return
            if rotation_code is not None:
                frame = cv2.rotate(frame, rotation_code)
            yield frame
            i += 1

    if pipeline:
        # decode frames in a background thread, and dispatch launches
        # ahead of their results: video IO, host work and the card's work
        # overlap. batch_frames > 1 runs that many frames a launch, for
        # extraction throughput where per-frame latency does not matter
        from simple_hrnet_tpu_torch.data.prefetch import prefetch_iter
        results = model.predict_stream(prefetch_iter(frames()),
                                       max_people=max_batch_size,
                                       batch_frames=batch_frames,
                                       adaptive_slots=adaptive_slots,
                                       compact_crops=compact_crops)
    else:
        results = (model.predict(f) for f in frames())

    index = 0
    t = time.time()
    for pts in results:
        if format == 'csv':
            for j, pt in enumerate(pts):
                row = [index, j] + pt.flatten().tolist()

                csv_writer.writerow(row)
        elif format == 'json':
            json_data[index] = [pt.tolist() for pt in pts]

        fps = 1.0 / max(time.time() - t, 1e-6)
        print(f'\rframerate: {fps:f} fps', end='')
        t = time.time()
        index += 1

    if format == 'csv':
        csv_file.close()
    elif format == 'json':
        with open(json_output_filename, 'w') as f:
            json.dump(json_data, f)
    video_source.release()
    print()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Extract and save keypoints in csv or json format.')
    parser.add_argument('--format', type=str, default=None)
    parser.add_argument('--filename', '-f', type=str, default=None)
    parser.add_argument('--hrnet_m', '-m', type=str, default='HRNet')
    parser.add_argument('--hrnet_c', '-c', type=int, default=48)
    parser.add_argument('--hrnet_j', '-j', type=int, default=17)
    parser.add_argument('--hrnet_weights', '-w', type=str,
                        default='./weights/pose_hrnet_w48_384x288.pth')
    parser.add_argument('--image_resolution', '-r', type=str,
                        default='(384, 288)')
    parser.add_argument('--single_person', action='store_true')
    parser.add_argument('--yolo_version', type=str, default='v3')
    parser.add_argument('--use_tiny_yolo', action='store_true')
    parser.add_argument('--max_batch_size', type=int, default=16)
    parser.add_argument('--csv_output_filename', type=str, default='output.csv')
    parser.add_argument('--csv_delimiter', type=str, default=',')
    parser.add_argument('--json_output_filename', type=str,
                        default='output.json')
    parser.add_argument('--device', type=str, default=None)
    parser.add_argument('--enable_tensorrt', action='store_true')
    parser.add_argument('--max_frames', type=int, default=None)
    parser.add_argument('--pipeline', action='store_true',
                        help='per-frame device pipeline with launches '
                             'dispatched ahead of their results and frames '
                             'decoded in a background thread '
                             '(multi-person only)')
    parser.add_argument('--batch_frames', type=int, default=1,
                        help='with --pipeline: frames per launch '
                             '(higher aggregate fps, batching latency)')
    parser.add_argument('--adaptive_slots', action='store_true',
                        help='with --pipeline: size the people-slot count '
                             'to the scene (max_batch_size becomes the '
                             'cap) — sparse scenes skip most of the pose '
                             'batch, crowded launches re-run one rung up')
    parser.add_argument('--compact_crops', action='store_true',
                        help='with --pipeline --batch_frames>1: size the '
                             'pose batch to the window\'s TOTAL detected '
                             'people (cross-frame compaction) instead of '
                             'batch_frames*slots — the exact-fit upgrade '
                             'of --adaptive_slots for chunked serving')
    return parser


if __name__ == '__main__':
    main(**build_parser().parse_args().__dict__)

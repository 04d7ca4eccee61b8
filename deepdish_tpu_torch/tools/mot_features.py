"""Offline MOTChallenge re-ID feature extraction CLI.

Port of deepdish_tpu/tools/mot_features.py, the equivalent of the batch
tool at tools/generate_detections.py:220-315 in the reference: reads
MOTChallenge sequences (`[sequence]/img1/*.jpg` + `[sequence]/det/det.txt`),
embeds every detection with the appearance encoder, and writes per-sequence
`.npy` files of rows `[det.txt row, 128-d feature]`. Each frame's crops are
embedded by the encoder's `encode_boxes` (crop-resize + forward on the
encoder's device) in padded batches of a fixed capacity.

Usage:
  python -m deepdish_tpu_torch.tools.mot_features --mot_dir DIR \
      --output_dir OUT [--model mars|dummy|constant] [--detection_dir DIR] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import create_box_encoder


@torch.inference_mode()
def extract_sequence(encoder, sequence_dir: str, detection_file: str,
                     batch_capacity: int = 32):
    import cv2

    dev = encoder.device
    image_dir = os.path.join(sequence_dir, "img1")
    image_filenames = {
        int(os.path.splitext(f)[0]): os.path.join(image_dir, f)
        for f in os.listdir(image_dir)}
    detections_in = np.loadtxt(detection_file, delimiter=',')
    if detections_in.ndim == 1:
        detections_in = detections_in[None]
    frame_indices = detections_in[:, 0].astype(int)
    out = []
    for frame_idx in range(frame_indices.min(), frame_indices.max() + 1):
        rows = detections_in[frame_indices == frame_idx]
        if frame_idx not in image_filenames or len(rows) == 0:
            if len(rows):
                print(f"WARNING: no image for frame {frame_idx}")
            continue
        bgr = cv2.imread(image_filenames[frame_idx], cv2.IMREAD_COLOR)
        rgb = torch.from_numpy(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)).to(dev)
        boxes = rows[:, 2:6].astype(np.float32)
        feats = np.zeros((len(boxes), encoder.feature_dim), np.float32)
        for start in range(0, len(boxes), batch_capacity):
            chunk = boxes[start:start + batch_capacity]
            pad = np.zeros((batch_capacity, 4), np.float32)
            pad[:len(chunk)] = chunk
            valid = np.arange(batch_capacity) < len(chunk)
            f, _ = encoder.encode_boxes(rgb, torch.from_numpy(pad).to(dev),
                                        torch.from_numpy(valid).to(dev))
            feats[start:start + len(chunk)] = \
                f.float().cpu().numpy()[:len(chunk)]
        out += [np.r_[row, feat] for row, feat in zip(rows, feats)]
    return np.asarray(out)


def generate_detections(encoder, mot_dir: str, output_dir: str,
                        detection_dir: str | None = None):
    detection_dir = detection_dir or mot_dir
    os.makedirs(output_dir, exist_ok=True)
    for sequence in sorted(os.listdir(mot_dir)):
        sequence_dir = os.path.join(mot_dir, sequence)
        if not os.path.isdir(sequence_dir):
            continue
        print(f"Processing {sequence}")
        det_file = os.path.join(detection_dir, sequence, "det/det.txt")
        arr = extract_sequence(encoder, sequence_dir, det_file)
        np.save(os.path.join(output_dir, f"{sequence}.npy"), arr,
                allow_pickle=False)


def main(argv=None):
    p = argparse.ArgumentParser(description="Re-ID feature extractor")
    p.add_argument("--model", default="mars-small128",
                   help="encoder selector (mars/dummy/constant)")
    p.add_argument("--mot_dir", required=True)
    p.add_argument("--detection_dir", default=None)
    p.add_argument("--output_dir", default="detections")
    p.add_argument("--device", default=None,
                   help="torch device (e.g. cpu); default: the card")
    args = p.parse_args(argv)
    encoder = create_box_encoder(args.model, device=args.device)
    generate_detections(encoder, args.mot_dir, args.output_dir,
                        args.detection_dir)


if __name__ == "__main__":
    main()

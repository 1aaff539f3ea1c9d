"""Turn a folder of rendered EXR frames into sRGB PNGs + a video file.

Counterpart of luisarender_tpu/tools/seq2video.py (LuisaRender's
tools/seq2video.py shells through OpenCV: exr read -> sRGB png -> mp4v
VideoWriter). Without cv2 or ffmpeg, EXR/PNG IO goes through utils/imageio,
and the video is a self-contained **uncompressed 24-bit DIB AVI** writer
(RIFF 'AVI ' with one 'vids'/'DIB ' stream — plays in VLC/ffplay/mpv).
Frames are bottom-up BGR rows, as the DIB format requires.
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from ..utils import imageio


def _srgb_encode(x):
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return np.where(
        x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1.0 / 2.4) - 0.055
    )


def write_avi(path, frames, fps):
    """Uncompressed AVI: frames (T, H, W, 3) uint8 RGB."""
    frames = np.asarray(frames)
    t, h, w, _ = frames.shape
    row_bytes = (w * 3 + 3) & ~3  # DIB rows pad to 4 bytes
    frame_bytes = row_bytes * h

    def chunk(fourcc, payload):
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc, payload):
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack(
        "<14I",
        int(1e6 / fps),  # microseconds per frame
        frame_bytes * fps,  # max bytes/sec
        0,  # padding granularity
        0x10,  # flags: HASINDEX
        t, 0, 1, frame_bytes, w, h, 0, 0, 0, 0,
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, t,
        frame_bytes, 0xFFFFFFFF, 0, 0, 0, int(w), int(h),
    )
    strf = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, 0, frame_bytes, 0, 0, 0, 0
    )
    hdrl = lst(
        b"hdrl",
        chunk(b"avih", avih)
        + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
    )

    movi_payload = b""
    offsets = []
    for fr in frames:
        # bottom-up BGR rows, 4-byte padded
        bgr = fr[::-1, :, ::-1]
        rows = np.zeros((h, row_bytes), np.uint8)
        rows[:, : w * 3] = bgr.reshape(h, w * 3)
        offsets.append(4 + len(movi_payload))
        movi_payload += chunk(b"00db", rows.tobytes())
    movi = lst(b"movi", movi_payload)

    idx = b""
    for off in offsets:
        idx += b"00db" + struct.pack("<III", 0x10, off, frame_bytes)
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("folder", help="folder of .exr frames")
    ap.add_argument("fps", type=int, help="frame rate")
    ap.add_argument(
        "--output", default=None, help="output video (default folder/output.avi)"
    )
    args = ap.parse_args(argv)
    folder = args.folder

    exrs = sorted(
        f for f in os.listdir(folder)
        if f.endswith(".exr") and not f.startswith("dump-")
    )
    print(f"Reading {len(exrs)} EXR frames from '{folder}'...")
    frames8 = []
    for i, name in enumerate(exrs):
        img = imageio.load_image(os.path.join(folder, name))[..., :3]
        png8 = np.uint8(np.round(_srgb_encode(img) * 255))
        frames8.append(png8)
        imageio.save_png(
            os.path.join(folder, name[:-4] + ".png"),
            _srgb_encode(img),
        )
        print(f"frame {i}: {name}")
    out = args.output or os.path.join(folder, "output.avi")
    write_avi(out, np.stack(frames8), args.fps)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Offline frame extraction: videos -> 1-based ``%05d.jpg`` frame dirs; the
port's counterpart of the JAX package's ``data/extract_frames.py`` (the
same commands, files and list).

Per video: ffprobe the aspect ratio, scale the SHORT side to ``res``
(Kinetics 320@30fps, UCF/HMDB 256@25fps), dump ``-q:v 2`` JPEGs, and drop a
``done`` marker so re-runs skip finished videos. Subprocess argument lists
(quote-safe paths), a ``--list-file`` that gets the ``relpath label
nframes`` annotation line per video, and parallel workers. Where no ffmpeg
binary is on the PATH, OpenCV decodes instead (``_extract_video_cv2``, the
same files and numbering).

CLI:  python -m cstp_tpu_torch.data.extract_frames --vid-dir D --frame-dir O \
          [--res 320 --fps 30 --workers 8 --redo --list-file out.txt]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple


def probe_hw(path: str, ffprobe: str = "ffprobe") -> Tuple[int, int]:
    """(width, height) via ffprobe."""
    out = subprocess.check_output(
        [ffprobe, "-v", "error", "-show_entries", "stream=width,height",
         "-of", "default=noprint_wrappers=1", path],
        text=True,
    )
    vals = {}
    for line in out.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            vals.setdefault(k, v)
    return int(vals["width"]), int(vals["height"])


def scale_arg(width: int, height: int, res: int) -> str:
    """Short side -> res, aspect preserved."""
    return f"-1:{res}" if width > height else f"{res}:-1"


def _extract_video_cv2(video_path: str, out_dir: str, res: int,
                       fps: int) -> int:
    """Decoder fallback for ffmpeg-less hosts: cv2 (OpenCV's bundled
    ffmpeg libs) decode + short-side scale + JPEG dump, with the same
    nearest-timestamp fps resampling ``ffmpeg -r`` performs. Frame files
    and numbering are identical to the ffmpeg path."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {video_path!r}")
    # STREAMING: resize+write each kept frame inside the read loop, holding
    # at most one raw frame at a time (a whole minutes-long Kinetics clip
    # is gigabytes of uint8, times --workers threads). The output
    # schedule is unchanged: output j takes the nearest-timestamp source
    # frame round(j*src_fps/fps) (ffmpeg -r semantics), with the tail
    # clamped to the final frame; n_out = round(n_src*fps/src_fps) is only
    # known at EOF, so trailing clamped outputs are emitted after the loop
    # from the retained last frame.
    tw = th = None

    def write(fr, j):
        nonlocal tw, th
        if tw is None:
            h, w = fr.shape[:2]
            if w > h:
                tw, th = int(round(w * res / h)), res
            else:
                tw, th = res, int(round(h * res / w))
        out = cv2.resize(fr, (tw, th), interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(out_dir, "%05d.jpg" % (j + 1)), out,
                    [cv2.IMWRITE_JPEG_QUALITY, 94])  # ffmpeg -q:v 2 class

    try:
        src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
        i, j, last = -1, 0, None
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            i += 1
            last = fr
            # emit every output whose nearest source frame is this one
            # (monotone in j, so no output is ever skipped or stalled)
            while int(round(j * src_fps / fps)) == i:
                write(fr, j)
                j += 1
    finally:
        cap.release()
    if last is None:
        raise RuntimeError("no frames decoded")
    n_src = i + 1
    n_out = max(1, int(round(n_src * fps / src_fps)))
    # rounding at EOF can leave the stream one frame over or under the
    # final schedule length: trim the surplus, clamp-fill the deficit
    for k in range(n_out, j):
        os.remove(os.path.join(out_dir, "%05d.jpg" % (k + 1)))
    while j < n_out:  # outputs past the last source timestamp: clamp
        write(last, j)
        j += 1
    return n_out


def extract_video(video_path: str, out_dir: str, res: int = 320,
                  fps: int = 30, redo: bool = False,
                  ffmpeg: str = "ffmpeg", ffprobe: str = "ffprobe") -> int:
    """Extract one video; returns frame count (0 on failure). Skips work if
    ``out_dir/done`` exists. Uses the ffmpeg binary when present, else the
    cv2 decoder."""
    done = os.path.join(out_dir, "done")
    if os.path.isfile(done) and not redo:
        return sum(1 for f in os.listdir(out_dir) if f.endswith(".jpg"))
    os.makedirs(out_dir, exist_ok=True)
    try:
        if shutil.which(ffmpeg) is None:
            nframes = _extract_video_cv2(video_path, out_dir, res, fps)
        else:
            w, h = probe_hw(video_path, ffprobe)
            subprocess.run(
                [ffmpeg, "-y", "-i", video_path, "-r", str(fps), "-q:v", "2",
                 "-vf", f"scale={scale_arg(w, h, res)}",
                 os.path.join(out_dir, "%05d.jpg")],
                check=True, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            nframes = sum(
                1 for f in os.listdir(out_dir)
                if f.endswith(".jpg") and len(f) == 9
            )
        if nframes == 0:
            raise RuntimeError("no frames produced")
        with open(done, "w"):
            pass
        return nframes
    except Exception as e:  # report the video and go on with the others
        print(f"ERROR {video_path}: {e}", file=sys.stderr)
        return 0


def extract_tree(vid_dir: str, frame_dir: str, res: int = 320, fps: int = 30,
                 redo: bool = False, workers: int = 4,
                 start: int = 0, end: Optional[int] = None,
                 ffmpeg: str = "ffmpeg", ffprobe: str = "ffprobe",
                 class_labels: bool = True) -> List[Tuple[str, int, int]]:
    """Walk ``vid_dir/<class>/<video>`` and extract everything.

    Returns [(relpath_without_ext, class_index, nframes), ...] for annotation
    emission; class index = sorted-class order (UCF-style labels).
    """
    classes = sorted(
        c for c in os.listdir(vid_dir) if os.path.isdir(os.path.join(vid_dir, c))
    )[start:end]
    jobs = []
    for ci, cls in enumerate(classes):
        for v in sorted(os.listdir(os.path.join(vid_dir, cls))):
            rel = os.path.join(cls, os.path.splitext(v)[0])
            jobs.append((os.path.join(vid_dir, cls, v),
                         os.path.join(frame_dir, rel), rel, ci))
    results = []
    with ThreadPoolExecutor(max(1, workers)) as pool:
        futs = [
            (rel, ci, pool.submit(extract_video, src, dst, res, fps, redo,
                                  ffmpeg, ffprobe))
            for src, dst, rel, ci in jobs
        ]
        for rel, ci, fut in futs:
            results.append((rel, ci, fut.result()))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cstp_tpu_torch.data.extract_frames")
    ap.add_argument("--vid-dir", required=True)
    ap.add_argument("--frame-dir", required=True)
    ap.add_argument("--res", type=int, default=320,
                    help="short side (Kinetics 320, UCF/HMDB 256)")
    ap.add_argument("--fps", type=int, default=30,
                    help="Kinetics 30, UCF/HMDB 25")
    ap.add_argument("--redo", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--list-file", default=None,
                    help="write 'relpath label nframes' annotation lines here")
    ap.add_argument("--ffmpeg", default="ffmpeg")
    ap.add_argument("--ffprobe", default="ffprobe")
    args = ap.parse_args(argv)

    if shutil.which(args.ffmpeg) is None:
        print(f"note: {args.ffmpeg!r} not on PATH — using the cv2 decoder "
              "fallback", file=sys.stderr)
    results = extract_tree(args.vid_dir, args.frame_dir, res=args.res,
                           fps=args.fps, redo=args.redo, workers=args.workers,
                           start=args.start, end=args.end,
                           ffmpeg=args.ffmpeg, ffprobe=args.ffprobe)
    ok = sum(1 for _, _, n in results if n > 0)
    print(f"extracted {ok}/{len(results)} videos -> {args.frame_dir}")
    if args.list_file:
        with open(args.list_file, "w") as f:
            for rel, ci, n in results:
                if n > 0:
                    f.write(f"{rel} {ci} {n}\n")
        print(f"wrote annotation list -> {args.list_file}")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())

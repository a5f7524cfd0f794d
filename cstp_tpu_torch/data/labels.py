"""Annotation/label-file parsing: the port's own copy of the JAX package's
``data/labels.py``.

Formats (reference ``data_process/*_labels/``, SURVEY §2.3):
* UCF-101 / HMDB-51: ``relpath label [nframes]`` single-space separated
  (``trainlist0{split}_nframe.txt`` / ``testlist0{split}_nframe.txt``,
  consumed at datasets.py:832-838);
* Kinetics: ``path  label  nframes`` double-space separated
  (``kin400_mmlab_labels/*_list_label_nframe.txt``, datasets.py:1280-1289).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class VideoRecord:
    path: str       # relative path, extension stripped like the reference
    label: int
    nframes: int


def parse_ucf_list(list_path: str, frame_dir: Optional[str] = None,
                   check_exists: bool = False) -> List[VideoRecord]:
    """UCF/HMDB ``relpath label nframes``; strips the media extension the way
    the reference does (``line_split[0].split('.')[0]``, datasets.py:835)."""
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            rel = parts[0].split(".")[0]
            label = int(parts[1])
            nframes = int(parts[2]) if len(parts) > 2 else -1
            if check_exists and frame_dir is not None:
                if not os.path.exists(os.path.join(frame_dir, rel)):
                    continue
            out.append(VideoRecord(rel, label, nframes))
    return out


def read_class_names(annotation_path: str) -> Optional[List[str]]:
    """``classInd.txt`` id->name map (reference datasets.py:201-203): the
    reference reads ``annotation_path/classInd.txt`` ("1 ApplyEyeMakeup"
    per line) and indexes names by FILE ORDER (``lab_names[label]``), so the
    leading 1-based id column is cosmetic. Returns the ordered name list,
    or None when the file is absent (labels still come from split lists
    either way — names only decorate test/retrieval reports)."""
    path = os.path.join(annotation_path, "classInd.txt")
    if not os.path.isfile(path):
        return None
    names = []
    with open(path) as f:
        for line in f:
            parts = line.strip("\n").split(" ")
            if len(parts) >= 2 and parts[1]:
                names.append(parts[1])
    return names or None


def parse_kinetics_list(list_path: str) -> List[VideoRecord]:
    """Kinetics ``path  label  [nframes]`` (double-space; datasets.py:1283-1289).

    The reference's non-nframe lists (``{train,val}_list_label.txt``, read by
    KINFTOnline/KINFTOnlineDecord at datasets.py:1740/1863) have only two
    columns; those parse with ``nframes=-1`` and are lazily probed from the
    container (``video.probe_nframes``) on first use."""
    out = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split("  ")
            if len(parts) < 2:
                continue
            nframes = int(parts[2]) if len(parts) > 2 else -1
            out.append(VideoRecord(parts[0].split(".")[0], int(parts[1]),
                                   nframes))
    return out


def kinetics_list_path(annotation_path: str, data_type: str) -> str:
    """Resolve the Kinetics annotation file: prefer the nframe-annotated list
    (``*_list_label_nframe.txt``, the format the reference's LMDB readers use,
    datasets.py:1280), falling back to the plain two-column list the
    video-file readers use (``*_list_label.txt``, datasets.py:1740/1863)."""
    split = "train" if data_type == "train" else "val"
    withn = os.path.join(annotation_path, f"{split}_list_label_nframe.txt")
    if os.path.isfile(withn):
        return withn
    return os.path.join(annotation_path, f"{split}_list_label.txt")


def train_list_name(split: str) -> str:
    return f"trainlist0{split}_nframe.txt"


def test_list_name(split: str) -> str:
    return f"testlist0{split}_nframe.txt"


def ucf_list_path(annotation_path: str, data_type: str, split: str) -> str:
    """Resolve a UCF/HMDB split list: prefer the ``*_nframe`` variant
    (``trainlist0N_nframe.txt``, datasets.py:832-838), falling back to the
    plain two-column ``trainlist0N.txt`` / ``testlist0N.txt`` the reference's
    own spatial-pretext classes read (datasets.py:39-41,120-122,210-212) and
    ships in ``UCF101_labels/``. Plain rows parse with ``nframes=-1`` and
    each backend probes the true count lazily on first use — the same
    fallback contract as :func:`kinetics_list_path`."""
    stem = (f"trainlist0{split}" if data_type == "train"
            else f"testlist0{split}")
    withn = os.path.join(annotation_path, f"{stem}_nframe.txt")
    if os.path.isfile(withn):
        return withn
    return os.path.join(annotation_path, f"{stem}.txt")

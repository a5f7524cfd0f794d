"""Offline shard tooling CLI: ``python -m cstp_tpu_torch.data.pack <cmd>``,
the port's counterpart of the JAX package's ``data/pack.py`` (the same
commands, files and printed lines):

  frames     frame-dir JPEGs + annotation list  -> CSTPack shard
  lmdb       reference LMDB shard + annotations -> CSTPack shard
  make-lmdb  frame-dir JPEG tree                -> reference-layout LMDB
  info       print a CSTPack shard's index summary
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m cstp_tpu_torch.data.pack")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("frames", help="pack a frame-dir tree into CSTPack")
    p.add_argument("--frame-dir", required=True)
    p.add_argument("--annotation", required=True,
                   help="UCF-style list file: relpath label [nframes]")
    p.add_argument("--out", required=True)
    p.add_argument("--raw-hw", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="store decoded raw frames at HxW (decode-free reads)")
    p.add_argument("--limit", type=int, default=0)

    p = sub.add_parser("lmdb", help="convert a reference LMDB shard to CSTPack")
    p.add_argument("--lmdb", required=True)
    p.add_argument("--annotation-path", required=True)
    p.add_argument("--dataset", default="UCF101")
    p.add_argument("--data-type", default="train", choices=["train", "val", "test"])
    p.add_argument("--split", default="1")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=0)

    p = sub.add_parser("make-lmdb",
                       help="build a reference-layout LMDB from a frame-dir tree")
    p.add_argument("--frame-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--file", action="store_true",
                   help="write a single data file instead of a subdir env")
    p.add_argument("--limit", type=int, default=0)

    p = sub.add_parser("info", help="print CSTPack shard summary")
    p.add_argument("path")

    args = ap.parse_args(argv)

    if args.cmd == "frames":
        from cstp_tpu_torch.data.packed import pack_frame_dir

        n = pack_frame_dir(args.frame_dir, args.annotation, args.out,
                           raw_hw=tuple(args.raw_hw) if args.raw_hw else None,
                           limit=args.limit)
        print(f"packed {n} videos -> {args.out}")
    elif args.cmd == "lmdb":
        from cstp_tpu_torch.data.lmdb_dataset import lmdb_to_cstpack

        n = lmdb_to_cstpack(args.lmdb, args.annotation_path, args.out,
                            dataset=args.dataset, data_type=args.data_type,
                            split=args.split, limit=args.limit)
        print(f"converted {n} videos -> {args.out}")
    elif args.cmd == "make-lmdb":
        from cstp_tpu_torch.data.lmdb_dataset import frame_dir_to_lmdb

        n = frame_dir_to_lmdb(args.frame_dir, args.out,
                              subdir=not args.file, limit=args.limit)
        print(f"wrote {n} videos -> {args.out}")
    elif args.cmd == "info":
        from cstp_tpu_torch.data.packed import PackedDataset

        ds = PackedDataset(args.path, ingest_hw=None)
        n = ds.num_videos()
        frames = sum(v.nframes for v in ds.index)
        print(f"{args.path}: {n} videos, {frames} frames, "
              f"codecs={{{', '.join(sorted({str(v.codec) for v in ds.index}))}}}")
        ds.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

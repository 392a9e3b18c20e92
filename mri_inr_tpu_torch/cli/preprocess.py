"""Offline preprocessing CLI (counterpart of the repository's
``preprocess.py``): ``.h5`` k-space volumes -> normalised ``.npy`` slices +
``metadata.csv``.

    python -m mri_inr_tpu_torch.cli.preprocess --path <h5 dir> [--output <dir>]
        [--masks 0.05:6 0.1:6] [--synthetic N] [--phase] [--snr-db DB]
        [--texture T] [--device cpu|cuda]

The default device is ``cuda`` (the reconstruction is the DFT kernel) and a
missing card raises; ``--device cpu`` reconstructs through ``torch.fft``.
Reading and writing ``.h5`` files needs ``h5py``.
"""

from __future__ import annotations

import argparse
import pathlib

from mri_inr_tpu_torch.data.preprocessing import process_files
from mri_inr_tpu_torch.data.synthetic import write_synthetic_h5
from mri_inr_tpu_torch.utils.device import resolve_device


def parse_mask(spec: str) -> tuple[float, int]:
    cf, acc = spec.split(":")
    return float(cf), int(acc)


def main(argv: list[str] | None = None) -> pathlib.Path:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--path", "-p", required=True, help="directory of .h5 files")
    parser.add_argument("--output", "-o", default=None)
    parser.add_argument("--masks", nargs="+", default=["0.05:6", "0.1:6"],
                        help="center_fraction:acceleration pairs")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="first generate N synthetic phantom volumes into --path")
    # hard-mode phantom knobs (data/synthetic.py)
    parser.add_argument("--phase", action="store_true", help="synthetic: complex phase maps")
    parser.add_argument("--snr-db", type=float, default=None,
                        help="synthetic: k-space noise SNR in dB")
    parser.add_argument("--texture", type=float, default=0.0,
                        help="synthetic: texture amplitude (e.g. 0.18)")
    parser.add_argument("--device", default=None,
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.synthetic:
        paths = write_synthetic_h5(args.path, num_files=args.synthetic, phase=args.phase,
                                   snr_db=args.snr_db, texture=args.texture)
        print(f"wrote {len(paths)} synthetic volumes to {args.path}")

    masks = [parse_mask(m) for m in args.masks]
    metadata = process_files(args.path, args.output, masks, device=device)
    print(f"metadata written to {metadata}")
    return metadata


if __name__ == "__main__":
    main()

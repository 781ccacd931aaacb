"""Command line interface: python -m jxl_tiny_tpu_torch.cli <input.pfm>
<output.jxl> [-d D] (argument-compatible with the JAX package's cli for the
options this port covers)."""
import argparse
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cjxl_tiny_torch",
        description="JPEG XL encoder (VarDCT, photographic) on a CUDA card",
    )
    p.add_argument("input", help="input PFM file (linear sRGB float)")
    p.add_argument("output", help="output .jxl")
    p.add_argument("-d", "--distance", type=float, default=1.0,
                   help="Butteraugli distance target (default 1.0)")
    p.add_argument("--f32-upload", action="store_true",
                   help="upload pixels as float32 (default float16)")
    p.add_argument("--no-cfl", action="store_true",
                   help="disable chroma-from-luma (OPTIMIZE_CHROMA_FROM_LUMA=0)")
    p.add_argument("--no-block-sizes", action="store_true",
                   help="disable 16x8/8x16 DCT selection "
                   "(OPTIMIZE_BLOCK_SIZES=0)")
    p.add_argument("--static-codes", action="store_true",
                   help="one-pass static entropy codes (OPTIMIZE_CODE=0)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                   "plain torch versions of the kernels)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    from .common import EncoderConfig
    from .encoder import encode_image_device
    from .errors import JxlTinyError
    from .io.pfm import read_pfm

    config = EncoderConfig(
        optimize_code=not args.static_codes,
        optimize_chroma_from_luma=not args.no_cfl,
        optimize_block_sizes=not args.no_block_sizes,
    )
    upload = None if args.f32_upload else np.float16
    try:
        img = read_pfm(args.input)
        if not args.quiet:
            print(f"Read {img.shape[2]}x{img.shape[1]} pixels input image.",
                  file=sys.stderr)
        t = time.time()
        data = encode_image_device(img, args.distance, upload_dtype=upload,
                                   config=config, device=args.device)
        dt = time.time() - t
        with open(args.output, "wb") as f:
            f.write(data)
    except (JxlTinyError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        mp = img.shape[1] * img.shape[2] / 1e6
        print(f"Compressed to {len(data)} bytes ({8 * len(data) / (1e6 * mp):.3f} "
              f"bpp) in {dt:.2f}s ({mp / dt:.1f} MP/s).", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

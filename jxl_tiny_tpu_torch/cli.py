"""Command line interface (argument-compatible with the JAX package's cli
for the options this port covers):

    python -m jxl_tiny_tpu_torch.cli <input.pfm> <output.jxl> [-d D]
    python -m jxl_tiny_tpu_torch.cli <a.pfm> <b.pfm> ... <output dir> [-d D]

With several inputs the output is a directory, and the images are
pipelined through the card (encode_images_device).

--pipeline picks the route of a single image: device (the default: the
analysis and the entropy packing on the card), host (the analysis on the
card, the codes and packing on the host: the JAX package's `tpu` choice,
encode_image_host_packed) or numpy (the golden model on the host,
encode_image). The three give codestreams of the same quantized image."""
import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cjxl_tiny_torch",
        description="JPEG XL encoder (VarDCT, photographic) on a CUDA card",
    )
    p.add_argument("input", nargs="+", help="input PFM file(s) (linear sRGB float)")
    p.add_argument("output", help="output .jxl (one input) or directory (several)")
    p.add_argument("-d", "--distance", type=float, default=1.0,
                   help="Butteraugli distance target (default 1.0)")
    p.add_argument("--pipeline", choices=("device", "host", "numpy"), default="device",
                   help="device = analysis + entropy packing on the card (default); "
                   "host = analysis on the card, packing on the host; numpy = "
                   "the host golden model")
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
    from .errors import JxlTinyError

    config = EncoderConfig(
        optimize_code=not args.static_codes,
        optimize_chroma_from_luma=not args.no_cfl,
        optimize_block_sizes=not args.no_block_sizes,
    )
    if config != EncoderConfig() and args.pipeline != "device":
        # The verification pipelines have the full-capability tier only;
        # failing beats encoding silently at another tier.
        p.error("capability-tier flags require --pipeline device")
    upload = None if args.f32_upload else np.float16
    try:
        if len(args.input) > 1:
            return _batch(args, config, upload)
        return _single(args, config, upload)
    except (JxlTinyError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _single(args, config, upload):
    from . import encoder
    from .io.pfm import read_pfm

    img = read_pfm(args.input[0])
    if not args.quiet:
        print(f"Read {img.shape[2]}x{img.shape[1]} pixels input image.",
              file=sys.stderr)
    t = time.time()
    if args.pipeline == "device":
        data = encoder.encode_image_device(img, args.distance, upload_dtype=upload,
                                           config=config, device=args.device)
    elif args.pipeline == "host":
        data = encoder.encode_image_host_packed(img, args.distance, upload_dtype=upload,
                                                device=args.device)
    else:
        data = encoder.encode_image(img, args.distance)
    dt = time.time() - t
    with open(args.output, "wb") as f:
        f.write(data)
    if not args.quiet:
        mp = img.shape[1] * img.shape[2] / 1e6
        print(f"Compressed to {len(data)} bytes ({8 * len(data) / (1e6 * mp):.3f} "
              f"bpp) in {dt:.2f}s ({mp / dt:.1f} MP/s).", file=sys.stderr)
    return 0


def _batch(args, config, upload):
    """Pipelined multi-image encode into an output directory."""
    from .encoder import encode_images_device
    from .io.pfm import read_pfm

    if not os.path.isdir(args.output):
        print(f"error: several inputs need an output directory: {args.output}",
              file=sys.stderr)
        return 1
    imgs = (read_pfm(path) for path in args.input)
    t = time.time()
    for path, data in zip(args.input, encode_images_device(
            imgs, args.distance, upload_dtype=upload, config=config,
            device=args.device)):
        out = os.path.join(args.output, os.path.splitext(os.path.basename(path))[0] + ".jxl")
        with open(out, "wb") as f:
            f.write(data)
        if not args.quiet:
            print(f"{path} -> {out} ({len(data)} bytes)", file=sys.stderr)
    if not args.quiet:
        print(f"Batch: {len(args.input)} images in {time.time() - t:.2f}s.",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Decode CLI for the verification decoder:

    python -m jxl_tiny_tpu_torch.decode input.jxl output.pfm

Decodes the subset of the format this encoder emits (VarDCT, xyb, linear
sRGB) back to a linear-sRGB float PFM — the in-repo stand-in for djxl in
round-trip checks."""
import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="djxl_tiny_torch")
    p.add_argument("input", help="input .jxl (emitted by this encoder)")
    p.add_argument("output", help="output PFM (linear sRGB float)")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    from .decoder import decode_jxl
    from ..io.pfm import write_pfm
    from ..errors import JxlTinyError

    try:
        data = open(args.input, "rb").read()
        t = time.time()
        img = decode_jxl(data)
        dt = time.time() - t
        write_pfm(args.output, img)
    except (JxlTinyError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(
            f"Decoded {img.shape[2]}x{img.shape[1]} pixels in {dt:.2f}s.",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

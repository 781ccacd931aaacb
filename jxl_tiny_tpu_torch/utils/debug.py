"""Debug mode: the counterpart of the JAX package's utils/debug.py and of the
reference's sanitizer builds (base/sanitizer_definitions.h).

`debug_mode()` is a context manager that turns on NaN checks, the
counterpart of jax_debug_nans: the output of each float stage of program A
(extract_groups, to_xyb, adaptive_quant_field, dct2d_8x8,
strategy_estimates) is checked, and the first NaN raises FloatingPointError
naming the stage and the group. Program B takes and gives integers only
(tokens, bit widths, words), so no NaN can arise there. Each check reads a
flag back to the host: it synchronizes, which only debug mode allows
(outside it the programs queue with no host sync).

The switch is a context variable read where the stages end, set only by
debug_mode and restored on exit, an exception included. It does not cross
into other processes: the ranks that tools/multihost_dryrun spawns start
with debug mode off.

Debug mode changes nothing the encode launches: on the card the kernels
run, and their outputs are what the NaN checks read. The counterpart of
interpret-mode Pallas is an argument of the entry points,
`encode_image_device(..., kernels=False)`, which runs every kernel's plain
torch version on the card; the two combine (`kernels=False` inside
debug_mode).

The sanitizer side is compute-sanitizer, run over this module's command
line, which encodes one image on the card and prints its size (where the
tool can attach to the card; PERF.md records a card machine where it could
not):

    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m jxl_tiny_tpu_torch.utils.debug testdata/gradient512.pfm
    compute-sanitizer --tool racecheck --error-exitcode 1 \\
        python -m jxl_tiny_tpu_torch.utils.debug testdata/gradient512.pfm --static-codes
"""
import contextlib
import contextvars

import torch

_NAN_CHECKS = contextvars.ContextVar("jxl_tiny_tpu_torch_nan_checks", default=False)


def nan_check(stage, *tensors):
    """In debug mode: raise FloatingPointError at the first NaN in the float
    tensors of a stage's output, [G, ...] with the group first. Does
    nothing (and reads nothing back) outside it."""
    if not _NAN_CHECKS.get():
        return
    for t in tensors:
        if not t.is_floating_point():
            continue
        bad = torch.isnan(t).reshape(t.shape[0], -1).any(dim=1)
        if bool(bad.any()):
            group = int(torch.nonzero(bad)[0, 0])
            raise FloatingPointError(
                f"NaN in the output of {stage}, group {group} (shape {tuple(t.shape)})")


@contextlib.contextmanager
def debug_mode():
    """Run the encodes inside the block with NaN checks (see the module
    docstring)."""
    token = _NAN_CHECKS.set(True)
    try:
        yield
    finally:
        _NAN_CHECKS.reset(token)


def main(argv=None):
    """Encode one image on the card (the kernels, outside debug mode) and
    print its size: the program compute-sanitizer runs."""
    import argparse

    from ..common import EncoderConfig
    from ..encoder import encode_image_device
    from ..io.pfm import read_pfm

    p = argparse.ArgumentParser(prog="jxl_tiny_tpu_torch.utils.debug")
    p.add_argument("input")
    p.add_argument("-d", "--distance", type=float, default=1.0)
    p.add_argument("--static-codes", action="store_true",
                   help="the one-pass static-code tier (EncoderConfig(optimize_code=False))")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    config = EncoderConfig(optimize_code=not args.static_codes)
    data = encode_image_device(read_pfm(args.input), args.distance, config=config,
                               device=args.device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    print(f"{args.input}: {len(data)} bytes")


if __name__ == "__main__":
    main()

"""Debug mode: the counterpart of the JAX package's utils/debug.py
(`debug_mode(nan_checks=True, interpret_pallas=True)`) and of the
reference's sanitizer builds (base/sanitizer_definitions.h).

`debug_mode(nan_checks=True, checked_kernels=True)` is a context manager
with two switches, each a context variable set on entry and restored on
exit (an exception included). Neither crosses into other processes: the
ranks that tools/multihost_dryrun spawns start with both off.

nan_checks, the counterpart of jax_debug_nans: the output of each float
stage of program A (extract_groups, to_xyb, adaptive_quant_field,
dct2d_8x8, strategy_estimates) is checked, and the first NaN raises
FloatingPointError naming the stage and the group. Program B takes and
gives integers only (tokens, bit widths, words), so no NaN can arise
there.

checked_kernels, the counterpart of interpret_pallas (Pallas run
interpreted, with bounds semantics, surfaces out-of-bounds indexing that
compiled mode may mask): on the card every kernel of the encode (aq,
strategy, quantize, tokenize, compact, bitpack; not the exactness probe's,
which the JAX debug mode does not reach either) runs from its checked
build (ops/_build.CHECKED_FLAGS, csrc/check.cuh). It tests every global
load and store against the element count of the buffer it touches, and
every shared-memory index against its array's size; an access outside is
skipped (a load gives zero) and the launch's first one is recorded. The
wrapper reads the record after each launch and raises IndexError naming
the kernel, the source line, the block and thread, the index and the
extent. Nothing traps, so the context stays usable. The checks see
indexes, not timing: a race between threads passes them. On the CPU the
wrappers run their plain versions, and the switch changes nothing.

Both checks read a value back to the host after the stage or launch: they
synchronize, which only debug mode allows (outside it the programs queue
with no host sync, and no extra launch or read-back happens), and which no
CUDA graph can capture: inside debug mode the programs run eagerly, and
the captured programs are dropped on entry and on exit (ops/programs). The bytes of
an encode inside debug mode equal those outside it. The plain torch
versions on the card are an argument of the entry points,
`encode_image_device(..., kernels=False)`; it combines with debug mode.

Where compute-sanitizer can attach to the card (PERF.md records a card
machine where it could not), it checks what the checked build does not,
races included, over this module's command line, which encodes one image
on the card and prints its size:

    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m jxl_tiny_tpu_torch.utils.debug testdata/gradient512.pfm
    compute-sanitizer --tool racecheck --error-exitcode 1 \\
        python -m jxl_tiny_tpu_torch.utils.debug testdata/gradient512.pfm --static-codes
"""
import contextlib
import contextvars

import torch

_NAN_CHECKS = contextvars.ContextVar("jxl_tiny_tpu_torch_nan_checks", default=False)
_CHECKED_KERNELS = contextvars.ContextVar("jxl_tiny_tpu_torch_checked_kernels", default=False)
_ACTIVE = contextvars.ContextVar("jxl_tiny_tpu_torch_debug_mode", default=False)


def active():
    """True inside debug_mode(), whatever its switches: the encoder's
    programs then run eagerly (ops/programs)."""
    return _ACTIVE.get()


def checked_kernels():
    """True inside debug_mode(checked_kernels=True): the kernel wrappers
    launch the checked builds (ops/_build.launch)."""
    return _CHECKED_KERNELS.get()


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
def debug_mode(nan_checks=True, checked_kernels=True):
    """Run the encodes inside the block with NaN checks and the kernels'
    checked builds (see the module docstring); each switch as given, both
    restored on exit. The programs run eagerly inside the block, and the
    captured programs (ops/programs) are dropped on entry and on exit, as
    the JAX debug mode drops its compiled executables: no graph captured
    outside is replayed inside, and none captured inside would outlive it."""
    from ..ops import programs

    programs.clear_programs()
    tokens = (_NAN_CHECKS.set(bool(nan_checks)), _CHECKED_KERNELS.set(bool(checked_kernels)),
              _ACTIVE.set(True))
    try:
        yield
    finally:
        _ACTIVE.reset(tokens[2])
        _CHECKED_KERNELS.reset(tokens[1])
        _NAN_CHECKS.reset(tokens[0])
        programs.clear_programs()


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

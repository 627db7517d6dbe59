"""bnz-compatible CLI of the port: ``python -m banzai_tpu_torch.cli``.

Counterpart of ``banzai_tpu/cli.py`` with the same flags, default output
names, deletion policy and exit codes 0/1/2/3, plus ``--device
cuda|cpu`` (default ``cuda``) in place of the JAX CLI's backend
selection by environment.  The encode streams through the port's
bounded-memory ``encode()``.  ``--device cuda`` without a CUDA device
exits 3 with one line before any output is opened; a failure during the
encode exits 3 and removes the partial output file.
"""

from __future__ import annotations

import os
import sys

# Exit codes of the reference's bnz (as ``banzai_tpu/cli.py``).
EXIT_OK = 0
EXIT_USAGE = 1
EXIT_INPUT_IO = 2
EXIT_OUTPUT_IO = 3

_DEVICES = ("cuda", "cpu")

_HELP = """usage: python -m banzai_tpu_torch.cli [flags] [--output <path>] <input|->

Compress a file to the bzip2 format on a CUDA card.

flags:
  -c, --stdout     write to standard output
  -k, --keep       keep the input file
  -r, --remove     remove the input file (default unless --output/-c/-k)
  -1 .. -9         block size 100kB..900kB (default 9)
      --fast       alias for -1
      --best       alias for -9
  -v, --verbose    per-block statistics to stderr
  --banzai-compat  reproduce the reference banzai's output byte-exactly
                   (quirk-exact model; larger and slower than the default)
      --device D   cuda (default) or cpu (the kernels' plain versions)
      --output P   write to P
      --help       this message
      --info       about this program
      --version    version string
"""

_INFO = (
    "banzai_tpu_torch: the banzai_tpu bzip2 encoder in PyTorch with CUDA\n"
    "kernels for Hopper.  RLE1 -> prefix-doubling BWT -> chunk-parallel\n"
    "MTF -> RLE2 -> package-merge Huffman -> bit packing.\n"
)


class Invocation:
    def __init__(self) -> None:
        self.input: str | None = None
        self.output: str | None = None
        self.stdout = False
        # None = default policy, True = -k, False = -r (last flag wins).
        self.keep_inf: bool | None = None
        self.verbose = False
        self.banzai_compat = False
        self.level: int | None = None
        self.device = "cuda"


class _InputIOError(Exception):
    """Read-side failure, tagged so it maps to exit 2 (input IO) instead
    of the output-IO handler catching the same OSError type."""


class _TaggedReader:
    """Wrap the input stream so read errors are distinguishable from
    write errors inside the shared encode() loop."""

    def __init__(self, f):
        self._f = f

    def read(self, n: int = -1):
        try:
            return self._f.read(n)
        except OSError as e:
            raise _InputIOError(str(e)) from e


def parse_args(argv: list[str]) -> Invocation | int:
    inv = Invocation()
    expect: str | None = None           # "output" or "device": value next
    no_more_flags = False
    for arg in argv:
        if expect is not None:
            setattr(inv, expect, arg)
            expect = None
            continue
        if not no_more_flags and arg == "--":
            no_more_flags = True
            continue
        if not no_more_flags and arg.startswith("--"):
            name = arg[2:]
            if name == "help":
                print(_HELP, end="")
                return EXIT_OK
            if name == "info":
                print(_INFO, end="")
                return EXIT_OK
            if name == "version":
                from . import __version__

                print(f"banzai_tpu_torch {__version__}")
                return EXIT_OK
            if name in ("output", "device"):
                expect = name
            elif name == "stdout":
                inv.stdout = True
            elif name == "keep":
                inv.keep_inf = True
            elif name == "remove":
                inv.keep_inf = False
            elif name == "verbose":
                inv.verbose = True
            elif name == "banzai-compat":
                inv.banzai_compat = True
            elif name == "fast":
                inv.level = 1
            elif name == "best":
                inv.level = 9
            else:
                print(f"bnz: unknown flag --{name}", file=sys.stderr)
                return EXIT_USAGE
            continue
        if not no_more_flags and arg.startswith("-") and arg != "-":
            for ch in arg[1:]:
                if ch == "c":
                    inv.stdout = True
                elif ch == "k":
                    inv.keep_inf = True
                elif ch == "r":
                    inv.keep_inf = False
                elif ch == "v":
                    inv.verbose = True
                elif ch.isdigit() and ch != "0":
                    inv.level = int(ch)
                else:
                    print(f"bnz: unknown flag -{ch}", file=sys.stderr)
                    return EXIT_USAGE
            continue
        if inv.input is not None:
            print("bnz: multiple inputs specified", file=sys.stderr)
            return EXIT_USAGE
        inv.input = arg
    if expect is not None:
        print(f"bnz: --{expect} requires a value", file=sys.stderr)
        return EXIT_USAGE
    if inv.device not in _DEVICES:
        print(f"bnz: --device must be one of {', '.join(_DEVICES)}",
              file=sys.stderr)
        return EXIT_USAGE
    if inv.input is None:
        print("bnz: no input specified (use - for stdin)", file=sys.stderr)
        return EXIT_USAGE
    if inv.level is None:
        inv.level = 9
    return inv


def main(argv: list[str] | None = None) -> int:
    inv = parse_args(sys.argv[1:] if argv is None else argv)
    if isinstance(inv, int):
        return inv

    from . import encode
    from ._device import resolve_device

    if not inv.banzai_compat:
        # A device that cannot run fails here, before any output exists.
        try:
            resolve_device(inv.device)
        except RuntimeError as e:
            print(f"bnz: {e}", file=sys.stderr)
            return EXIT_OUTPUT_IO

    # Stream the input, never slurp it.
    if inv.input == "-":
        reader = sys.stdin.buffer
        close_reader = False
    else:
        try:
            reader = open(inv.input, "rb")
        except OSError as e:
            print(f"bnz: cannot read {inv.input}: {e}", file=sys.stderr)
            return EXIT_INPUT_IO
        close_reader = True

    # Unspecified output: <input>.bz2 for a file, stdout for stdin.
    out_path: str | None = None
    if not inv.stdout and (inv.output is not None or inv.input != "-"):
        out_path = inv.output if inv.output is not None else inv.input + ".bz2"
        # Opening the input itself for writing would truncate it first.
        try:
            same = inv.input != "-" and os.path.exists(out_path) and (
                os.path.samefile(inv.input, out_path)
            )
        except OSError:
            same = False
        if same:
            print(
                f"bnz: input file {inv.input} is the same as output file "
                f"{out_path}", file=sys.stderr,
            )
            if close_reader:
                reader.close()
            return EXIT_OUTPUT_IO
        try:
            writer = open(out_path, "wb")
        except OSError as e:
            print(f"bnz: cannot write {out_path}: {e}", file=sys.stderr)
            if close_reader:
                reader.close()
            return EXIT_OUTPUT_IO
    else:
        writer = sys.stdout.buffer
    close_writer = out_path is not None

    report = None
    if inv.verbose:
        from .profiling import EncodeReport

        report = EncodeReport(level=inv.level)

    def _drop_partial() -> None:
        # A truncated .bz2 would only fail at decompress time: remove it
        # (file outputs only).
        if out_path is not None:
            try:
                writer.close()
            except Exception:
                pass
            try:
                os.unlink(out_path)
            except OSError:
                pass

    try:
        if inv.banzai_compat:
            # The quirk-exact reference model, byte-identical to the
            # reference banzai's stream.
            from .oracle import banzai_compress

            writer.write(
                banzai_compress(_TaggedReader(reader).read(), inv.level)
            )
        else:
            encode(_TaggedReader(reader), writer, inv.level, inv.device,
                   report=report)
        if not close_writer:
            writer.flush()
    except BrokenPipeError:
        # The reader went away (e.g. `... -c x | head`): quiet exit.
        try:
            sys.stdout.close()
        except Exception:
            pass
        return EXIT_OUTPUT_IO
    except _InputIOError as e:
        print(f"bnz: cannot read {inv.input}: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_INPUT_IO
    except OSError as e:
        print(f"bnz: error during compression: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_OUTPUT_IO
    except KeyboardInterrupt:
        _drop_partial()
        raise
    except Exception as e:
        # Any other failure mid-encode (a device batch that raised, the
        # CUDA runtime): one line, no partial output file, exit 3.
        print(f"bnz: error during compression: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_OUTPUT_IO
    finally:
        if close_reader:
            reader.close()
        if close_writer:
            try:
                writer.close()
            except OSError as e:
                # A buffered flush can fail only here (e.g. ENOSPC).
                print(
                    f"bnz: error during compression: {e}", file=sys.stderr
                )
                return EXIT_OUTPUT_IO

    if report is not None:
        print(report.summary(), file=sys.stderr)

    # Default keeps the input only when an output destination was given
    # (--output or -c); -k/-r override.  A failed deletion exits 3.
    keep = inv.keep_inf
    if keep is None:
        keep = inv.stdout or inv.output is not None
    if not keep and inv.input != "-":
        try:
            os.unlink(inv.input)
        except OSError as e:
            print(f"bnz: error deleting input file: {e}", file=sys.stderr)
            return EXIT_OUTPUT_IO
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())

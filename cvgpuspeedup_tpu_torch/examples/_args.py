"""The command line every example takes."""

import argparse


def parse(doc: str, argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where to run: the current CUDA device unless given (cpu for the CPU)")
    return ap.parse_args(argv)


def shape(t) -> tuple:
    return tuple(t.shape)


def dtype(t) -> str:
    """A tensor's dtype as numpy names it (float32, uint8)."""
    return str(t.dtype).removeprefix("torch.")

"""The benchmark's plain reference encoder: NumPy only.

The pure-NumPy path of the port's host encoder (``encoder_host``),
frozen, with its C helpers left out, RLE1 written plainly from the runs
(``rle1``) and the rotation sort done by ``bwt.bwt`` (prefix doubling
over the unresolved groups only, the same column and ``ptr``).  It imports nothing of the program and
takes nothing the program made: the harness hands it the job bytes.
"""

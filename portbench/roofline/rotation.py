"""Work of the seeded Hadamard rotation of n rows of d dims into d' dims:
one sign multiply a dim and one addition or subtraction a dim at each of
the log2(d') stages; the f32 rows read once and the f32 rotated rows
written once."""


def work(n: int, d: int, d_pad: int) -> tuple:
    ops = float(n) * d + float(n) * d_pad * (d_pad.bit_length() - 1)
    return ops, 4.0 * n * d + 4.0 * n * d_pad

"""Work of a full 4-bit scan of b rotated queries over n packed rows of d'
dims: one f32 multiply-add a query, row and dim (2 operations); the codes
(d'/2 bytes a row), the f32 queries and row norms read once, the f32 scores
written once."""


def work(b: int, n: int, d_pad: int) -> tuple:
    ops = 2.0 * b * n * d_pad
    nbytes = n * d_pad / 2 + 4.0 * b * d_pad + 4.0 * n + 4.0 * b * n
    return ops, nbytes

"""Work of the sign proxy of b queries over n rows of d' dims: the rows' sign
codes (d'/8 bytes a row) and the queries' sign bits read once, the int32
proxies written once.  Counted as bytes: the bit operations are not f32
work."""


def work(b: int, n: int, d_pad: int) -> tuple:
    nbytes = n * d_pad / 8 + b * d_pad / 8 + 4.0 * b * n
    return 0.0, nbytes

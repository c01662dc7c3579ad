"""``fused_conv_block``'s share of its roofline in the forwards of the
traced range: the least time the card needs for the residual convs'
work (each conv's operations and bytes, counted from its shapes, at the
card's peak or its HBM rate, whichever binds) over the device time of
the conv-block kernels by name.

Each residual conv of a forward over ``rows`` windows is one launch at N
= 6 rows, L = the frame positions it runs at, C = the filters, k taps: ``2 N L k
C^2`` operations; bytes are the input and the output once, the weights,
the residual where the kernel adds it (DYT blocks' second conv) and one
byte a row position of each mask in a masked program. The same work is
counted whatever kernel does it.
"""

from benchmark.harness.flops import residual_convs
from benchmark.harness.peaks import bound_s

LAYER = "kernels (ops/fused_conv.py, csrc/fused_conv_block.cu)"
UNIT = "%"
MOVES = "predict_windows_per_s"
#: the conv-block kernels, by the names the profiler gives them
KERNELS = ("conv_bf16_wgmma", "conv_bf16_stream", "conv_f32_ring")
ELEM = {"bfloat16": 2, "float32": 4}


def forward_bound_s(model_cfg: dict, rows: int, masked: bool, precision: str) -> float:
    n = 6 * rows
    e = ELEM[precision]
    total = 0.0
    for length, c, k, dyt, second in residual_convs(model_cfg):
        residual = dyt and second
        act = n * length * c * e
        nbytes = (3 if residual else 2) * act + k * c * c * e + (2 * n * length if masked else 0)
        total += bound_s(2.0 * n * length * k * c * c, nbytes, precision)
    return total


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs, launches = t.kernel_seconds(KERNELS)
    if not launches or secs <= 0:
        return None
    bound = sum(count * forward_bound_s(ctx["model_cfg"], rows, program != "dense",
                                        ctx["settings"]["precision"])
                for (rows, program), count in ctx["traced_forwards"].items())
    return 100.0 * bound / secs if bound else None
